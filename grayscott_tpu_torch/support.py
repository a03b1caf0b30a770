"""The port's support matrix: the port of ``grayscott_tpu/support.py``.

Engine (K1-K7) x boundary x dtype x layout combinations and their status
on the card: the one table that the README renders, that ``simulate
--help`` and ``livesim --help`` print as their epilog
(``cli/shared.py:add_shared_args``), and that
``tests/test_torch_support.py`` sweeps. Every ``rejected`` row raises
:class:`grayscott_tpu_torch.errors.UnsupportedConfigError` (a
``ValueError``) when the combination is pinned, and names the ROADMAP.md
item that would port it; ``auto`` rows run when the selection (a measured
record, or the port's ranking) picks them, or when pinned; nothing falls
back silently when the user pinned a combination.
"""

from __future__ import annotations

#: (combination, status, note). status: "ok" = runs when asked for;
#: "auto" = applied when the selection picks it, or pinned; "rejected" =
#: UnsupportedConfigError when pinned.
MATRIX: tuple[tuple[str, str, str], ...] = (
    ("engine=windowed (K1) x any boundary x f32/bf16", "ok",
     "8 steps a launch on 64x64 tiles; the fold's entries under "
     "naive_fold"),
    ("engine=mega (K2) x any boundary x f32/bf16", "ok",
     "the whole run in one cooperative launch; the fold's entries under "
     "naive_fold"),
    ("resident (K3) x f32", "auto",
     "'on' forces; auto runs it on naive domains that fit L2; rejected "
     "with bf16, an engine pin, naive_fix=store or naive_fold"),
    ("pack (K4, K5, K6) x zero boundary x f32 x separable stencil", "auto",
     "'on' forces; auto packs only on a measured record; rejected with the "
     "naive boundary, bf16 or 5points"),
    ("bf16 storage x windowed/mega/sharded", "ok",
     "rounded to bfloat16 once a block of 8 steps; rejected with "
     "resident=on or pack=on"),
    ("naive_fold x naive x windowed/mega x f32/bf16", "ok",
     "the folded naive reaction (ulp-budget mode); rejected with the zero "
     "boundary, naive_fix=store or resident=on"),
    ("naive_fix=store/slice x naive", "ok",
     "the exact naive path (the kernels have no strips to patch); rejected "
     "with the zero boundary, store also with resident=on or "
     "mega_specialize"),
    ("mega_depth 2..8 x mega (K2)", "ok",
     "the window ring: D slots and the step's scratch; 64x64 tiles at "
     "depth 2-3, 32x32 at 4-8; depth 2 under 2*D tiles; ValueError outside "
     "2..8; declined on the packed layout (K6 keeps its double buffer, as "
     "JAX's packed megakernel takes no depth); no effect on the other "
     "engines"),
    ("mega_specialize x any engine", "ok",
     "no-op: interior tiles always step without the boundary selects, "
     "bitwise; rejected with naive_fix=store; declined on the packed "
     "layout"),
    ("steps_per_call=8 x cuda", "ok",
     "the kernels' own K: auto then runs K1 unpacked (JAX's explicit-K "
     "rule)"),
    ("sharded mega (K7) x 1-D/2-D mesh x f32/bf16", "ok",
     "all shards on one card; row meshes wait at the read site, 2-D meshes "
     "gate each time block's entry"),
    ("sharded windowed (K1's shard entry) x 1-D/2-D mesh x f32/bf16", "ok",
     "--sharded-overlap splits interior and edge calls where a shard has "
     "interior tiles"),
    ("bf16 storage x resident/pack/lane fold", "rejected",
     "bf16 rides K1, K2 and the sharded engines only"),
    ("lane fold (fold > 1)", "rejected",
     "ROADMAP.md Queue 2 item 7 (the lane-fold layout); auto, off and 1 "
     "run"),
    ("block_rows/block_cols pins, steps_per_call other than 8", "rejected",
     "ROADMAP.md Queue 2 item 8 (column tiles, the temporal depth and the "
     "tile pins)"),
    ("GRAYSCOTT_COORDINATOR (several processes)", "rejected",
     "ROADMAP.md Queue 1 item 7.2 (several processes over "
     "torch.distributed)"),
)


def render(fmt: str = "markdown") -> str:
    """The support matrix as a markdown table or plain-text epilog."""
    if fmt == "markdown":
        lines = ["| configuration | status | notes |", "|---|---|---|"]
        for combo, status, note in MATRIX:
            lines.append(f"| {combo} | {status} | {note} |")
        return "\n".join(lines)
    width = max(len(c) for c, _, _ in MATRIX)
    lines = ["the port's support matrix (pinning a rejected combination "
             "raises UnsupportedConfigError):"]
    for combo, status, note in MATRIX:
        lines.append(f"  {combo:<{width}}  [{status}] {note}")
    return "\n".join(lines)
