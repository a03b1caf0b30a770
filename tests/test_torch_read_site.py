"""K7's 1-D read-site wait on the CPU: where it applies (JAX's rule,
``grayscott_tpu/ops/megakernel.py:428-463``: a mesh of one column, more
than one shard, more than one window row), and that the wrapper's plain
version is the same for both waits and launches nothing. The kernel is held
bit for bit against the entry gate and the plain version on the card by
tests/test_torch_gpu.py and ``chip_smoke.py``."""

import pytest

torch = pytest.importorskip("torch")

from grayscott_tpu_torch.ops import sharded_mega
from grayscott_tpu_torch.parallel import halo
from grayscott_tpu_torch.params import Parameters, kernel_constants

from conftest import random_uv


@pytest.mark.parametrize("shape,mesh,tile,applies", [
    ((1080, 1920), (4, 1), 64, True),   # 272-row shards: 5 tile rows
    ((1080, 1920), (2, 1), 32, True),
    ((4096, 4096), (4, 1), 64, True),
    ((1080, 1920), (2, 2), 64, False),  # 2-D: the entry gate
    ((1080, 1920), (1, 4), 64, False),  # one row of shards, 2-D halos
    ((1080, 1920), (1, 1), 64, False),  # one shard: no neighbour
    ((100, 64), (2, 1), 64, False),     # 56-row shards: one tile row
    ((100, 64), (2, 1), 32, True),      # two tile rows of 32
])
def test_where_the_read_site_wait_applies(shape, mesh, tile, applies):
    assert sharded_mega.read_site_applies(shape, mesh, tile) == applies
    r_loc, _ = halo.shard_extents(shape, halo.Mesh(*mesh, None))
    window_rows = -(-r_loc // tile)
    assert applies == (mesh[1] == 1 and mesh[0] > 1 and window_rows > 1)


@pytest.mark.parametrize("read_site", [True, False])
def test_cpu_runs_the_plain_version_for_both_waits(rng, read_site):
    shape = (300, 200)
    u, v = random_uv(rng, shape)
    mesh = halo.make_mesh(4, 1, "cpu")
    consts = kernel_constants(Parameters())
    got, want = (halo.mega_shard_state(u, v, mesh) for _ in range(2))
    for pairs in (got, want):
        for p in pairs:
            halo.exchange_halos(p)
    before = (sharded_mega.launches, sharded_mega.read_site_launches)
    sharded_mega.sharded_megastep(*got, mesh, 3, 8, consts, "naive", shape,
                                  read_site=read_site)
    assert (sharded_mega.launches, sharded_mega.read_site_launches) == before
    sharded_mega.sharded_megastep_reference(*want, 3, 8, consts, "naive",
                                            shape)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
