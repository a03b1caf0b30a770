"""The window ring's walk (``csrc/gs_tile_sm90.cuh:ring_walk``) through its
CPU twin, ``ops/megakernel.py:ring_walk_plan``: the entries' walk
(RING_SCRATCH: each step writes the other of two buffers, the step's
scratch the ring's last) and the in-place walk of the ablation parts 5-7
(RING_IN_PLACE), replayed event by event for every tile count 0..24,
every buffer count the ring takes (2..9: depth D runs D + 1, a depth
clamped to 2 on 32x32 tiles two; in place D) and 1..8 steps a tile. Each
buffer's content is followed through the loads issued when the time block
begins, and for each tile its wait, the barrier that opens it, its steps
(each followed by a barrier), the loads issued after them (in place:
after the opening barrier) and its write-out, which ends at the next
barrier. No buffer is refilled, or written by a step, while it holds a
window not yet stepped, a result not yet written out or a write-out not
yet past a barrier; each tile's result is written out from the buffer its
last step wrote; at most D - 1 loads are in flight while a tile steps; and
the wait before a tile leaves only later tiles' loads in flight."""

import pytest

pytest.importorskip("torch")

from grayscott_tpu_torch.ops import geometry, megakernel

TILES = range(25)
BUFFERS = range(2, megakernel.RING_MAX_BUFFERS + 1)
STEPS = range(1, 9)

DEAD = ("dead", None)


def replay(n, nbuf, steps, in_place):
    """Walk the plan of ``n`` tiles; assert its invariants as it goes."""
    plan = megakernel.ring_walk_plan(n, nbuf, steps, in_place=in_place)
    assert len(plan) == n
    depth = nbuf if in_place else nbuf - 1
    state = {b: DEAD for b in range(nbuf)}
    what = (n, nbuf, steps, in_place)

    def issue(k):
        b = plan[k]["load"]
        assert 0 <= b < nbuf, what
        assert state[b] == DEAD, (what, k, b, state[b])
        state[b] = ("window", k)

    for k in range(n):
        if plan[k]["issued_at"] == -1:
            issue(k)
    for j in range(n):
        later = [k for k in range(j + 1, n) if plan[k]["issued_at"] < j]
        # the wait leaves only loads of later tiles in flight
        assert plan[j]["issued_at"] < j and plan[j]["wait"] <= len(later)
        # the barrier that opens tile j ends the last write-out
        state = {b: DEAD if c[0] == "storing" else c
                 for b, c in state.items()}
        if in_place:
            for k in range(j + 1, n):
                if plan[k]["issued_at"] == j:
                    issue(k)
        in_flight = [k for k in range(j + 1, n)
                     if plan[k]["issued_at"] < j
                     or (in_place and plan[k]["issued_at"] == j)]
        assert len(in_flight) == plan[j]["in_flight"] <= depth - 1, what
        cur = plan[j]["steps"][0][0]
        assert state[cur] == ("window", j), (what, j, state[cur])
        assert len(plan[j]["steps"]) == steps
        for read, written in plan[j]["steps"]:
            assert read == cur, what
            if written != read:
                assert state[written] == DEAD, (what, j, written)
                state[read] = DEAD
            state[written] = ("step", j)
            cur = written
        state[cur] = ("result", j)
        if not in_place:
            for k in range(j + 1, n):
                if plan[k]["issued_at"] == j:
                    issue(k)
        assert plan[j]["store"] == cur, what
        assert state[cur] == ("result", j)
        state[cur] = ("storing", j)
    assert all(c[0] in ("dead", "storing") for c in state.values())


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("nbuf", BUFFERS)
def test_ring_walk_plan_invariants(nbuf, steps, in_place):
    for n in TILES:
        replay(n, nbuf, steps, in_place)


@pytest.mark.parametrize("in_place", [False, True])
def test_ring_walk_keeps_depth_minus_one_in_flight(in_place):
    """A long walk keeps the ring full: D - 1 loads in flight while each
    tile steps, until the last tiles run out of windows to load."""
    for nbuf in BUFFERS:
        depth = nbuf if in_place else nbuf - 1
        for steps in (7, 8):
            plan = megakernel.ring_walk_plan(24, nbuf, steps,
                                             in_place=in_place)
            assert [t["in_flight"] for t in plan] == [
                min(depth - 1, 23 - j) for j in range(24)]


@pytest.mark.parametrize("nbuf", [1, 10, 0])
def test_ring_walk_plan_refuses_other_buffer_counts(nbuf):
    with pytest.raises(ValueError, match="nbuf"):
        megakernel.ring_walk_plan(4, nbuf, 8)


@pytest.mark.parametrize("tiles,depth,per_sm", [
    ((16, 64), 4, 2),   # 102,400 B: two blocks of 512 threads
    ((16, 64), 5, 1),   # 122,880 B: one of 1024
    ((32, 128), 3, 1),  # 221,184 B
    ((8, 256), 3, 1),   # 208,896 B
    ((8, 64), 3, 2),    # 61,440 B: room for three, the bound allows two
])
def test_pinned_ring_blocks_follow_its_kernels(tiles, depth, per_sm):
    """A pinned ring's blocks an SM are what its kernels run: two of 512
    threads where its bytes leave room for two, else one of 1024."""
    g = geometry.Geometry(*tiles, geometry.HALO)
    ring = megakernel.ring_geometry((1080, 1920), depth, tiles=g)
    assert ring.depth == depth and ring.buffers == depth + 1
    assert ring.blocks_per_sm == per_sm
    assert megakernel.pinned_two_blocks(ring.bytes) == (per_sm == 2)
