"""The port's support matrix: the port of ``grayscott_tpu/support.py``.

Engine (K1-K7) x boundary x dtype x layout combinations and their status
on the card: the one table that the README renders, that ``simulate
--help`` and ``livesim --help`` print as their epilog
(``cli/shared.py:add_shared_args``), and that
``tests/test_torch_support.py`` sweeps. Every ``rejected`` row raises
:class:`grayscott_tpu_torch.errors.UnsupportedConfigError` (a
``ValueError``) when the combination is pinned, as JAX's backend refuses
it; ``auto`` rows run when the selection (a measured record, or the port's
ranking) picks them, or when pinned; ``pinned`` rows run only under the
pins that name them; nothing falls back silently when the user pinned a
combination.
"""

from __future__ import annotations

#: (combination, status, note). status: "ok" = runs when asked for;
#: "auto" = applied when the selection picks it, or pinned; "pinned" =
#: runs under the pins that name it, never picked by the selection;
#: "rejected" = UnsupportedConfigError when pinned.
MATRIX: tuple[tuple[str, str, str], ...] = (
    ("engine=windowed (K1) x any boundary x f32/bf16", "ok",
     "8 steps a launch on 64x64 tiles unless pinned; the fold's entries "
     "under naive_fold"),
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
     "rounded to bfloat16 once a block of K steps (8, or K1's "
     "steps_per_call pin); rejected with resident=on or pack=on"),
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
    ("mega_depth > 2 x block_rows/block_cols x mega (K2) x f32/bf16/fold",
     "pinned",
     "the window ring on the pinned tiles (a pin equal to 64x64: the "
     "compiled ring's tiles); depth 2 under JAX's clamp (tile rows < 2*D on "
     "one tile column, else (tile rows - 1) x tile columns < 2*D); a ring "
     "past 232,448 B of shared memory rejected with its bytes"),
    ("mega_specialize x any engine", "ok",
     "no-op: interior tiles always step without the boundary selects, "
     "bitwise; rejected with naive_fix=store; declined on the packed "
     "layout"),
    ("steps_per_call 1..32 x windowed (K1, K4) x f32/bf16/fold", "ok",
     "K steps a launch in windows of max(ceil(K/8)*8, 8) cells; K <= 8 on "
     "64x64 tiles runs the compiled entries, the rest the pinned ones; "
     "auto then runs K1, packed only on pack=on; ValueError outside 1..32; "
     "rejected with engine=mega unless 8"),
    ("block_rows/block_cols x windowed (K1, K4) x f32/bf16/fold", "ok",
     "K1's tile height and width (K4's height: block_cols rejected with "
     "pack=on, as in JAX); an unpinned dimension 64, or the largest "
     "multiple of 8 whose window fits; a window past 232,448 B of shared "
     "memory rejected with its bytes; auto then runs K1"),
    ("block_rows/block_cols x mega (K2) x f32/bf16/fold", "ok",
     "K2's tile height (a positive multiple of 8) and width (a positive "
     "multiple of 128; at least the domain's width: unpinned), else JAX's "
     "refusal, also of a column tile with naive_fix=store; an unpinned "
     "dimension 64 or the largest multiple of 8 whose window fits; a window "
     "past 232,448 B rejected with its bytes; an engine: mega record's "
     "tiles where none is pinned"),
    ("block_rows x mega x pack (K6)", "ok",
     "K6's tile height (a positive multiple of 8, else JAX's refusal); "
     "block_cols rejected with pack=on, as in JAX"),
    ("sharded mega (K7) x 1-D/2-D mesh x f32/bf16", "ok",
     "all shards on one card; row meshes wait at the read site, 2-D meshes "
     "gate each time block's entry; K = 8 only"),
    ("block_rows/block_cols x sharded mega (K7) x 1-D/2-D mesh x f32/bf16",
     "ok",
     "each shard's tile height (a positive multiple of 8) and width (a "
     "positive multiple of 128; at least the domain's width on a row mesh "
     "unpinned, on a 2-D mesh one tile column across the shard), else "
     "JAX's refusal; the read-site wait finds its tile row from the pinned "
     "height"),
    ("sharded windowed (K1's shard entry) x 1-D/2-D mesh x f32/bf16", "ok",
     "--sharded-overlap splits interior and edge calls where a shard has "
     "interior tiles"),
    ("steps_per_call 1..32/block_rows x sharded windowed x f32/bf16", "ok",
     "K steps a launch with halos of max(ceil(K/8)*8, 8) rows (and "
     "columns on a 2-D mesh), bf16 rounded once a K-step block; the row "
     "tile of each shard; block_cols rejected, as in JAX; a shard thinner "
     "than its halo rejected; overlap splits at the pinned tile"),
    ("lane fold (fold > 1) x windowed (K1) x f32", "auto",
     "an int pins F: K1's folded entry, every K and row tile, bit for bit "
     "the unfolded K1; auto folds only on a record whose fold > 1; rejected "
     "with bf16, block_cols, resident=on, naive_fold, engine=mega, pack=on "
     "and panels thinner than the halo; the naive boundary at any width "
     "(JAX's TPU run needs C % 128 == 0, auto still does)"),
    ("bf16 storage x resident/pack/lane fold", "rejected",
     "bf16 rides K1, K2 and the sharded engines only"),
    ("GRAYSCOTT_COORDINATOR (several processes)", "ok",
     "simulate over a gloo process group: the sharded windowed engine (K1's "
     "shard entry, every K, row tile, bf16 and overlap), each process "
     "stepping its block of the mesh (whole mesh rows or an equal part of "
     "one), halo bands through pinned host memory, process 0 writes; other "
     "backends, --autotune and engine=mega rejected (K7 across processes "
     "and NCCL with one rank a card: ROADMAP.md Queue 1 item 7.3); livesim "
     "and the bench ignore the variable"),
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
