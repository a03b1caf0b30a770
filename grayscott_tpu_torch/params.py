"""Simulation parameters, and their carry-over into the port's kernels.

``Parameters`` and the stencil and preset tables are the port's own copy of
``grayscott_tpu/params.py``, trimmed to what the port uses (the reference's
parameter set, ``data/src/parameters.rs``), with the separable plan of
the stencil. :func:`kernel_constants` turns a ``Parameters`` into the
float32 numbers that the plain PyTorch step and the CUDA kernels K1-K3 take
at run time; :func:`packed_constants` does the same for the species-packed
step and its kernels K4-K6, through the copies of the JAX package's
separable plan and zero-boundary fold (``plan_alpha``,
``zero_fold_coeffs``: ``grayscott_tpu/ops/pallas_stencil.py:1002-1032``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

from .errors import UnsupportedConfigError

#: Floating-point precision of the simulation
Precision = np.float32

WeightsT = Tuple[Tuple[float, float, float], ...]

#: The four selectable 3x3 stencils, row-major
STENCILS: dict[str, WeightsT] = {
    # optimally isotropic discretisation of the Laplacian; the default
    "oono-puri": (
        (0.25, 0.5, 0.25),
        (0.5, 0.0, 0.5),
        (0.25, 0.5, 0.25),
    ),
    # all-ones stencil of the course's C++ version
    "pretty": (
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
        (1.0, 1.0, 1.0),
    ),
    # rotationally invariant, smallest error around the origin
    "patra-karttunen": (
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
        (4.0 / 6.0, 0.0, 4.0 / 6.0),
        (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0),
    ),
    # computationally simpler but anisotropic
    "5points": (
        (0.0, 1.0, 0.0),
        (1.0, 0.0, 1.0),
        (0.0, 1.0, 0.0),
    ),
}

DEFAULT_STENCIL = "oono-puri"

#: (row, col) of the centre weight
STENCIL_OFFSET = (1, 1)

#: Named (feed_rate, kill_rate) pattern presets (Pearson's regime map)
PRESETS: dict[str, Tuple[float, float]] = {
    "reference": (0.014, 0.054),
    "solitons": (0.030, 0.062),
    "mitosis": (0.0367, 0.0649),
    "coral": (0.0545, 0.062),
    "maze": (0.029, 0.057),
    "worms": (0.058, 0.065),
    "waves": (0.014, 0.045),
    "u-skate": (0.062, 0.061),
    "chaos": (0.026, 0.051),
}


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Gray-Scott simulation parameters (the reference's defaults)."""

    weights: WeightsT = STENCILS[DEFAULT_STENCIL]
    diffusion_rate_u: float = 0.1
    diffusion_rate_v: float = 0.05
    feed_rate: float = 0.014
    kill_rate: float = 0.054
    time_step: float = 1.0

    @classmethod
    def with_stencil(cls, name: str = DEFAULT_STENCIL,
                     **kwargs) -> "Parameters":
        if name not in STENCILS:
            raise ValueError(
                f"unknown stencil {name!r}; available: {sorted(STENCILS)}")
        return cls(weights=STENCILS[name], **kwargs)

    @classmethod
    def with_preset(cls, name: str, stencil: str = DEFAULT_STENCIL,
                    **kwargs) -> "Parameters":
        """Parameters of a named preset (:data:`PRESETS`); explicit
        ``feed_rate``/``kill_rate`` kwargs override the preset's pair."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; available: {sorted(PRESETS)}")
        f, k = PRESETS[name]
        kwargs.setdefault("feed_rate", f)
        kwargs.setdefault("kill_rate", k)
        return cls.with_stencil(stencil, **kwargs)

    def weights_array(self) -> np.ndarray:
        """Stencil weights as a float32 (3, 3) array."""
        return np.asarray(self.weights, dtype=Precision)

    def corrected_weights(self) -> np.ndarray:
        """The weights with the naive formulation's ``-center`` term folded
        into the centre weight (``data/src/parameters.rs:57-63``): a
        sequential float32 sum over the row-major weights, the reference's
        fold order."""
        w = self.weights_array().copy()
        total = Precision(0.0)
        for x in w.reshape(-1):
            total = Precision(total + x)
        w[STENCIL_OFFSET] = Precision(w[STENCIL_OFFSET] - total)
        return w

    def min_feed_kill(self) -> Precision:
        """The ``-(feed_rate + kill_rate)`` prefactor of the dv update."""
        return Precision(-(Precision(self.feed_rate)
                           + Precision(self.kill_rate)))

    def stencil_name(self) -> str:
        for name, w in STENCILS.items():
            if w == self.weights:
                return name
        return "custom"

    def separable_plan(self):
        """The corrected stencil as a separable pass, where it is one.

        A symmetric stencil ``[[a,b,a],[b,c,b],[a,b,a]]`` with ``a > 0`` is
        ``conv_h(rows) . conv_h(cols) - alpha * centre`` with ``h = [x, y,
        x]``, ``x = sqrt(a)``, ``y = b / x`` and ``alpha = y*y - c +
        sum(w)``. Returns ``("separable", h, alpha)``, ``h`` float32 and
        ``alpha`` a float32 from float64 arithmetic, or ``("direct",
        corrected_weights)``. The separable pass reassociates the float32
        sum, so it is a few ulp off the oracle's 9-tap tree."""
        w = np.asarray(self.weights, dtype=np.float64)
        a, b = w[0, 0], w[0, 1]
        symmetric = (
            np.allclose(w, w.T)
            and w[0, 0] == w[0, 2] == w[2, 0] == w[2, 2]
            and w[0, 1] == w[1, 0] == w[1, 2] == w[2, 1]
        )
        if symmetric and a > 0:
            x = np.sqrt(a)
            y = b / x
            alpha = y * y - w[1, 1] + w.sum()
            h = np.asarray([x, y, x], dtype=Precision)
            return ("separable", h, Precision(alpha))
        return ("direct", self.corrected_weights())


class KernelConstants(NamedTuple):
    """Run-time constants of one Gray-Scott step, each exactly a float32.

    ``weights``: the 9 stencil weights, row-major. ``reaction``:
    ``(Du, Dv, f, -(f+k), dt)``.
    """

    weights: Tuple[float, ...]
    reaction: Tuple[float, ...]


def kernel_constants(params: Parameters) -> KernelConstants:
    """The float32 constants of ``params``, rounded exactly as the first
    five entries of the JAX kernel's reaction operand
    (``grayscott_tpu/ops/pallas_stencil.py:reaction_operand``).

    Python floats that hold float32 values: a float32 tensor times one of
    them computes in float32, so the plain step rounds as the oracle does.
    """
    weights = tuple(float(w) for w in params.weights_array().reshape(-1))
    reaction = (
        Precision(params.diffusion_rate_u),
        Precision(params.diffusion_rate_v),
        Precision(params.feed_rate),
        params.min_feed_kill(),
        Precision(params.time_step),
    )
    return KernelConstants(weights, tuple(float(x) for x in reaction))


def plan_alpha(params: Parameters) -> np.float32:
    """The separable plan's centre-correction scalar (0 for a direct
    plan, whose corrected weights already hold the centre)."""
    plan = params.separable_plan()
    return Precision(plan[2] if plan[0] == "separable" else 0.0)


def zero_fold_coeffs(du, dv, f, mfk, dt, alpha):
    """``(Cu, Cv, E, Au, Bv)`` of the zero boundary's linear fold:

        u' = ((Cu*s_u - dt*uv2) + E) + Au*u
        v' = ( (Cv*s_v + dt*uv2)     + Bv*v)

    with ``s`` the raw separable convolution (no ``- alpha*x``): every
    u-linear term of ``u + dt*(Du*(s - alpha*u) - uv2 + f*(1-u))`` in one
    coefficient. Host float32 arithmetic in a fixed order."""
    one = Precision(1.0)
    du, dv = Precision(du), Precision(dv)
    f, mfk, dt = Precision(f), Precision(mfk), Precision(dt)
    alpha = Precision(alpha)
    cu = dt * du
    cv = dt * dv
    e = dt * f
    au = (one - e) - cu * alpha
    bv = (one + dt * mfk) - cv * alpha
    return cu, cv, e, au, bv


class PackedConstants(NamedTuple):
    """Run-time constants of one species-packed step, each exactly a
    float32 (``ops/packed.py`` has the step they feed).

    ``h0``, ``h1``: the side and centre taps of the separable pass.
    ``cu``, ``cv``, ``e``, ``au``, ``bv``: the linear fold. ``dt``: the
    time step; ``dt_is_one``: the quadratic term's coefficient is then
    ``-1``/``+1`` rather than ``-dt``/``+dt``."""

    h0: float
    h1: float
    cu: float
    cv: float
    e: float
    au: float
    bv: float
    dt: float
    dt_is_one: bool

    def quadratic(self) -> Tuple[float, float]:
        """``(qu, qv)``: the coefficients of ``uv^2`` in U's and V's
        update."""
        if self.dt_is_one:
            return -1.0, 1.0
        return -self.dt, self.dt


def packed_constants(params: Parameters) -> PackedConstants:
    """The float32 constants of ``params`` for the species-packed step,
    rounded as the JAX kernel's (``grayscott_tpu/ops/pallas_stencil.py:
    reaction_operand``, entries 4-9, and ``Parameters.separable_plan``).
    Only a separable stencil packs: another raises
    :class:`UnsupportedConfigError`."""
    plan = params.separable_plan()
    if plan[0] != "separable":
        raise UnsupportedConfigError(
            f"pack requires a separable stencil plan; "
            f"{params.stencil_name()!r} has none", combo="pack")
    h = plan[1]
    dt = Precision(params.time_step)
    fold = zero_fold_coeffs(params.diffusion_rate_u, params.diffusion_rate_v,
                            params.feed_rate, params.min_feed_kill(), dt,
                            plan_alpha(params))
    return PackedConstants(float(h[0]), float(h[1]),
                           *(float(x) for x in fold), float(dt),
                           float(dt) == 1.0)


class FoldConstants(NamedTuple):
    """Run-time constants of one step of the folded naive reaction, each
    exactly a float32: the port's copy of what
    ``grayscott_tpu/ops/pallas_stencil.py:make_window_stepper(...,
    fast_fold=True)`` computes on the host (``:568-576``, ``:646-653``).
    ``ops/stencil.py:step_naive_fold`` has the step they feed.

    ``weights``: the 9 stencil weights, row-major (the two anchored
    strips, and the direct plan's sum). ``separable``: whether the
    stencil has a separable plan; ``h0``, ``h1`` its side and centre
    taps (0.0 without one). ``cu``, ``cv``, ``e``: the zero boundary's
    linear fold (:func:`zero_fold_coeffs`); ``dt``, ``dt_is_one``: the
    quadratic term's factor. ``au0``, ``bv0``: the u-linear coefficients
    without the boundary weight sum, ``1 - e`` and ``1 + dt*(-(f+k))``
    (the strips take them). ``row_sums``: the separable plan's sums of
    the taps of ``h`` in bounds at an axis's (first, middle, last)
    index, which make the boundary weight field ``b = rows * cols``;
    ``direct_sums``: the direct plan's, ``direct_sums[i]`` those of
    weight row ``i`` along the columns. ``au``, ``bv``: ``au0 - cu*b`` and ``bv0 - cv*b`` at a cell of
    row >= 1 and column >= 1, the only cells that take them, indexed
    ``2 * (row is the last) + (column is the last)``."""

    weights: Tuple[float, ...]
    separable: bool
    h0: float
    h1: float
    cu: float
    cv: float
    e: float
    dt: float
    dt_is_one: bool
    au0: float
    bv0: float
    row_sums: Tuple[float, float, float]
    direct_sums: Tuple[Tuple[float, float, float], ...]
    au: Tuple[float, float, float, float]
    bv: Tuple[float, float, float, float]

    def kernel_floats(self) -> Tuple[float, ...]:
        """The floats of the fold entries' constant array, in the order of
        ``csrc/gs_tile_sm90.cuh:FoldConstants``."""
        return (*self.weights, self.h0, self.h1, self.cu, self.cv, self.e,
                self.dt, self.au0, self.bv0, *self.au, *self.bv)


def _b_value(fc: FoldConstants, last_row: bool,
             last_col: bool) -> np.float32:
    """The boundary weight field of ``fc``'s stencil at a cell of row >= 1
    and column >= 1, in JAX's float32 order (``pallas_stencil.py:
    464-547``)."""
    if fc.separable:
        # (JAX's row factor takes the first sum at both ends; h is
        # symmetric, so it equals the last)
        row = fc.row_sums[0 if last_row else 1]
        col = fc.row_sums[2 if last_col else 1]
        return Precision(row) * Precision(col)
    one = Precision(1.0)
    ok_bot = Precision(0.0 if last_row else 1.0)
    cw = [Precision(s[2 if last_col else 1]) for s in fc.direct_sums]
    return (one * cw[0] + one * cw[1]) + ok_bot * cw[2]


def _in_bounds_sums(h: np.ndarray) -> Tuple[float, float, float]:
    """(first, middle, last): the sums of the taps of ``h`` that lie in
    bounds at an axis's first index, inside, and at its last index, as
    JAX's ``_col_sums`` rounds them."""
    return (float(Precision(h[1] + h[2])), float(h.sum()),
            float(Precision(h[0] + h[1])))


def fold_constants(params: Parameters) -> FoldConstants:
    """The float32 constants of ``params`` for the folded naive reaction,
    rounded in JAX's order (``pallas_stencil.py:556-576``): ``au0 = 1 -
    e`` and ``bv0 = 1 + dt*(-(f+k))`` on the host in float32, the edge
    sums as ``_col_sums`` and the direct plan's ``make_b_field`` take
    them, and ``au``/``bv`` as ``au0 - cu*b``, ``bv0 - cv*b``."""
    plan = params.separable_plan()
    w = params.weights_array()
    dt = Precision(params.time_step)
    cu, cv, e, _, _ = zero_fold_coeffs(
        params.diffusion_rate_u, params.diffusion_rate_v, params.feed_rate,
        params.min_feed_kill(), dt, plan_alpha(params))
    au0 = Precision(1.0) - e
    bv0 = Precision(1.0) + dt * params.min_feed_kill()
    separable = plan[0] == "separable"
    h = plan[1] if separable else np.zeros(3, dtype=Precision)
    fc = FoldConstants(
        weights=tuple(float(x) for x in w.reshape(-1)), separable=separable,
        h0=float(h[0]), h1=float(h[1]), cu=float(cu), cv=float(cv),
        e=float(e), dt=float(dt), dt_is_one=float(dt) == 1.0,
        au0=float(au0), bv0=float(bv0),
        row_sums=_in_bounds_sums(h),
        direct_sums=tuple(_in_bounds_sums(w[i]) for i in range(3)),
        au=(0.0,) * 4, bv=(0.0,) * 4)
    au, bv = [], []
    for last_row in (False, True):
        for last_col in (False, True):
            b = _b_value(fc, last_row, last_col)
            au.append(float(au0 - cu * b))
            bv.append(float(bv0 - cv * b))
    return fc._replace(au=tuple(au), bv=tuple(bv))
