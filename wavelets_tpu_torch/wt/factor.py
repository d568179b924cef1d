"""Lifting factorization of arbitrary orthogonal filter banks.

The reference ships hand-coded lifting schemes for FOUR wavelets only
(cdf9/7, haar, db1, db2 — src/WT/wt_main.jl:451-480); every other
family is filter-transform-only.  This module removes that limit: any
OrthoFilter is factored into predict/update lifting steps at
construction time (host-side float64, cached per filter), so
``wavelet(c, "lifting")`` — and with it the lifting engine's exact
non-periodic boundaries — works for EVERY orthogonal family.

Method (Daubechies & Sweldens, "Factoring wavelet transforms into
lifting steps", J. Fourier Anal. Appl. 4(3), 1998): write the analysis
polyphase matrix over Laurent polynomials in the half-rate shift z,
using this engine's own conventions (ops/filter_fb.py:dwt_level and
ops/lifting.py:lift_steps):

    [a; d] = P [s0; d0],   P = [[He, Ho], [Go, Ge]]

    He = sum_j h[2j] z^j        Ho = sum_j h[2j+1] z^j
    Go = -sum_j h[2j+1] z^-j    Ge = sum_j h[2j] z^-j

(g[m] = (-1)^m h[m] gives Ge(z) = He(1/z), Go(z) = -Ho(1/z), so
det P = He(z)He(1/z) + Ho(z)Ho(1/z) = 1 exactly by orthonormality —
P is in SL(2) over Laurent polynomials and the factorization

    P = diag(n1, n2) * M_k * ... * M_1,
    M_predict = [[1, -C], [0, 1]],  M_update = [[1, 0], [-C, 1]]

exists with CONSTANT diagonal.)  A forward lifting step s -= C(z) d is
exactly lift_steps' predict with C = sum_t coef[t] z^(t - shift), so the
factors map 1:1 onto LSStep tuples and lifting_level_fw reproduces
dwt_level to f64 rounding.

Laurent division is non-unique; the Euclidean descent is a small
depth-first search over remainder-window placements (each division has
span(a)-span(b)+1 candidate windows, solved as a square linear system),
with monomial "re-injection" moves to escape terminal z^a phase
monomials.  Branches are ordered by remainder norm and pruned on
coefficient blow-up; the found factorization is verified by
reconstructing P numerically before it is accepted.
"""

from __future__ import annotations

import numpy as np

from .schemes import LSStep, PREDICT, UPDATE

__all__ = ["lifting_factorization", "polyphase", "cascade_gain"]


def cascade_gain(steps) -> float:
    """Worst-case intermediate growth of a lifting cascade,
    prod_steps (1 + sum|coef|) — an upper bound on the edge-operator
    norm when the periodic cancellation is perturbed (non-periodic
    boundaries) and on the f32 round-trip cancellation loss."""
    g = 1.0
    for st in steps:
        g *= 1.0 + sum(abs(c) for c in st.coef)
    return g


def boundary_blowup(steps, n1: float, n2: float, boundary: str,
                    n: int = 256, levels: int = 3) -> float:
    """MEASURED max output coefficient magnitude of a multi-level
    forward transform under the given extension, on a unit-amplitude
    probe (numpy f64 mirror of ops/lifting.py's step semantics).

    A lifting cascade composes to the bounded filter bank only through
    cancellation between steps; a non-periodic extension perturbs that
    cancellation at the edges, so high-gain schemes emit edge
    coefficients ~blowup that COMPOUND level over level (the amplified
    edge of the scaling band is re-amplified) and the round-trip loses
    ~blowup^2 * eps — useless for f32 work and for thresholding
    semantics.  One level is not predictive (a scheme can have a large
    but boundary-robust transient); the multi-level FINAL coefficients
    are what applications see, so that is what is gated on."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, n)

    def step_sum(src, coef, shift):
        acc = np.zeros_like(src)
        for k, c in enumerate(coef):
            sh = shift - k
            term = np.roll(src, sh)
            if sh != 0 and boundary != "periodic":
                if boundary == "symmetric":
                    if sh > 0:
                        term[:sh] = src[:sh][::-1]
                    else:
                        term[sh:] = src[sh:][::-1]
                else:  # zeropad
                    if sh > 0:
                        term[:sh] = 0.0
                    else:
                        term[sh:] = 0.0
            acc += c * term
        return acc

    peak = 1.0
    for _l in range(levels):
        s = x[0::2].copy()
        d = x[1::2].copy()
        for st in steps:
            if st.kind == PREDICT:
                s = s - step_sum(d, st.coef, st.shift)
            else:
                d = d - step_sum(s, st.coef, st.shift)
        s *= n1
        d *= n2
        peak = max(peak, float(np.abs(s).max()), float(np.abs(d).max()))
        x = s
        if len(x) < 8:
            break
    return peak


def boundary_roundtrip_error(steps, n1: float, n2: float, boundary: str,
                             n: int = 512, levels: int = 4,
                             dtype=np.float32) -> float:
    """MEASURED multi-level round-trip error of the scheme under the
    given extension, in the given dtype, on a unit-amplitude probe —
    a numpy mirror of ops/lifting.py's exact semantics.  This is the
    construction-time stability gate for non-periodic boundaries: the
    reconstruction is algebraically exact for ANY scheme (each step is
    invertible under any deterministic extension), but schemes whose
    step cascade has large internal gain lose that exactness to
    floating-point cancellation at the edges, compounding per level."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1.0, 1.0, n).astype(dtype)

    def step_sum(src, coef, shift):
        acc = np.zeros_like(src)
        for k, c in enumerate(coef):
            sh = shift - k
            term = np.roll(src, sh)
            if sh != 0 and boundary != "periodic":
                if boundary == "symmetric":
                    if sh > 0:
                        term[:sh] = src[:sh][::-1]
                    else:
                        term[sh:] = src[sh:][::-1]
                else:  # zeropad
                    if sh > 0:
                        term[:sh] = 0.0
                    else:
                        term[sh:] = 0.0
            acc += dtype(c) * term
        return acc

    bands = []
    x = x0
    for _l in range(levels):
        s = x[0::2].copy()
        d = x[1::2].copy()
        for st in steps:
            if st.kind == PREDICT:
                s = s - step_sum(d, st.coef, st.shift)
            else:
                d = d - step_sum(s, st.coef, st.shift)
        s = s * dtype(n1)
        d = d * dtype(n2)
        bands.append(d)
        x = s
        if len(x) < 8:
            break
    for d in reversed(bands):
        s = x * dtype(1.0 / n1)
        d = d * dtype(1.0 / n2)
        for st in reversed(steps):
            if st.kind == PREDICT:
                s = s + step_sum(d, st.coef, st.shift)
            else:
                d = d + step_sum(s, st.coef, st.shift)
        x = np.stack([s, d], axis=-1).reshape(-1)
    return float(np.abs(x - x0).max())


_STAB_CACHE: dict = {}

# Max tolerated probe round-trip error per working precision: ~40x the
# probe shows up in a 2-D multi-level transform (measured, see
# BENCHMARKS.md), so these keep end-to-end degradation below ~4e-3 (f32)
# / ~4e-9 (f64).
_STAB_MAX = {4: 1e-4, 8: 1e-10}
# The PERIODIC wrap is algebraically exact for any scheme, but a cascade
# with large internal gain still amplifies floating-point rounding:
# Vaidyanathan's factorization measures a 14.2 (!) f32 probe error where
# every other stock scheme measures <= 7e-6 (and 1.9e-8 at f64 — usable,
# hence the looser f64 limit).  Found by fuzzing; without this gate
# vaid-lifting silently produced ~0.4 round-trip error at f32.
_STAB_MAX_PERIODIC = {4: 1e-4, 8: 1e-6}


def check_boundary_stability(scheme, dtype) -> None:
    """Raise if the scheme's cascade measurably loses round-trip
    exactness at this working precision (see boundary_roundtrip_error)
    — at the edges for non-periodic extensions, or anywhere for
    cascades whose internal gain amplifies rounding (vaid at f32).
    Cached per (scheme, boundary, precision); called at trace time so
    it costs nothing at run time."""
    itemsize = np.dtype(dtype).itemsize
    probe_dtype = np.float64 if itemsize == 8 else np.float32
    key = (scheme.steps, scheme.norm1, scheme.norm2, scheme.boundary,
           itemsize)
    err = _STAB_CACHE.get(key)
    if err is None:
        err = boundary_roundtrip_error(
            scheme.steps, scheme.norm1, scheme.norm2, scheme.boundary,
            dtype=probe_dtype)
        _STAB_CACHE[key] = err
    table = (_STAB_MAX_PERIODIC if scheme.boundary == "periodic"
             else _STAB_MAX)
    lim = table.get(itemsize, table[4])
    if err > lim:
        raise ValueError(
            f"lifting scheme {scheme.name!r} is numerically unstable "
            f"under boundary {scheme.boundary!r} at this precision "
            f"(measured probe round-trip error {err:.1e} > {lim:.0e}): "
            "the factored cascade's internal gain amplifies rounding.  "
            "Use float64, transform='filter', or (for non-periodic) "
            "boundary='periodic'/'zeropad'.")

_TOL = 1e-11
_DEFECT_MAX = 1e-5   # max tolerated orthonormality defect of the table


class _LP:
    """Laurent polynomial: coefficient c[i] belongs to z^(lo + i)."""

    __slots__ = ("lo", "c")

    def __init__(self, lo: int, c):
        c = np.asarray(c, np.float64)
        nz = np.nonzero(np.abs(c) > _TOL)[0]
        if len(nz) == 0:
            self.lo = 0
            self.c = np.zeros(0)
        else:
            self.lo = lo + int(nz[0])
            self.c = c[nz[0]: nz[-1] + 1].copy()

    @property
    def zero(self) -> bool:
        return len(self.c) == 0

    @property
    def hi(self) -> int:
        return self.lo + len(self.c) - 1

    @property
    def span(self) -> int:
        return len(self.c)

    def __add__(self, o: "_LP") -> "_LP":
        if self.zero:
            return o
        if o.zero:
            return self
        lo = min(self.lo, o.lo)
        hi = max(self.hi, o.hi)
        c = np.zeros(hi - lo + 1)
        c[self.lo - lo: self.lo - lo + len(self.c)] += self.c
        c[o.lo - lo: o.lo - lo + len(o.c)] += o.c
        return _LP(lo, c)

    def __neg__(self) -> "_LP":
        return _LP(self.lo, -self.c)

    def __sub__(self, o: "_LP") -> "_LP":
        return self + (-o)

    def __mul__(self, o: "_LP") -> "_LP":
        if self.zero or o.zero:
            return _LP(0, [])
        return _LP(self.lo + o.lo, np.convolve(self.c, o.c))

    def norm(self) -> float:
        return float(np.abs(self.c).max()) if len(self.c) else 0.0

    def __repr__(self):
        return f"LP(z^{self.lo} * {self.c})"


def _divmod_variants(a: _LP, b: _LP):
    """All (q, r) with a = q*b + r and span(r) < span(b), one per
    placement of the remainder window inside a's degree range (the
    non-uniqueness of Laurent division).  Yields in arbitrary order;
    the caller sorts by remainder norm."""
    if a.zero:
        return
    if b.zero:
        raise ZeroDivisionError
    sa, sb = a.span, b.span
    if sa < sb:
        yield _LP(0, []), a
        return
    nq = sa - sb + 1
    qlo = a.lo - b.lo
    degs = np.arange(a.lo, a.hi + 1)
    # column j of M: contribution of q_j (degree qlo+j) to each degree
    M = np.zeros((sa, nq))
    for j in range(nq):
        lo = qlo + j + b.lo - a.lo     # = j
        M[lo: lo + sb, j] = b.c
    for t in range(sa - sb + 1):
        # remainder window = degrees [a.lo + t, a.lo + t + sb - 2]
        outside = np.ones(sa, bool)
        outside[t: t + sb - 1] = False
        Mo = M[outside]
        ao = a.c[outside]
        try:
            q = np.linalg.solve(Mo, ao)
        except np.linalg.LinAlgError:
            continue
        if not np.all(np.isfinite(q)) or np.abs(q).max() > 1e8:
            continue
        qp = _LP(qlo, q)
        r = a - qp * b
        if r.span >= sb:
            continue
        yield qp, r


def _monomial(p: _LP):
    """(degree, coef) if p is a monomial, else None."""
    if p.span == 1:
        return p.lo, float(p.c[0])
    return None


def _retrim(p: _LP, slack: float) -> _LP:
    """Drop edge coefficients below ``slack`` — tables published to
    limited precision (orthonormality defect ~1e-10..1e-7) leave junk of
    that size on every Euclidean remainder, which otherwise blocks the
    zero/monomial terminal tests.  The peel STEPS stay exact; only the
    descent's decisions use the slackened view, and the final
    verification bounds the total error."""
    if p.zero or slack <= _TOL:
        return p
    nz = np.nonzero(np.abs(p.c) > slack)[0]
    if len(nz) == 0:
        return _LP(0, [])
    return _LP(p.lo + int(nz[0]), p.c[nz[0]: nz[-1] + 1])


def _step_of(kind: str, C: _LP) -> LSStep:
    """LSStep for the forward action s/d -= sum_t coef[t] src[i+t-shift],
    i.e. C(z) = sum_t coef[t] z^(t-shift)."""
    return LSStep(kind, tuple(C.c.tolist()), -C.lo)


class _Budget:
    def __init__(self, n: int, maxdepth: int, want: int,
                 slack: float = 0.0):
        self.n = n
        self.maxdepth = maxdepth
        self.want = want          # stop after this many successes
        self.slack = slack        # table-defect tolerance (see _retrim)
        self.found = []

    def tick(self) -> bool:
        self.n -= 1
        return self.n > 0 and len(self.found) < self.want


def _descend(Q, steps, budget, depth: int, injects: int):
    """DFS: peel lifting steps off the right of Q until
    Q = [[n1, 0], [0, n2]].  Appends every (steps, n1, n2) success to
    ``budget.found`` (the caller selects the best-conditioned one —
    the SHORTEST factorization is often numerically terrible, e.g.
    db4's 5-step path carries 1.2e5 coefficients while its 7-step one
    stays under 3).

    Peels (right-multiplication by the step INVERSE):
      predict^-1: col2 += C * col1   (reduces Q12 mod Q11)
      update^-1:  col1 += C * col2   (reduces Q11 mod Q12)

    Branch order prefers small remainders AND small step coefficients
    (huge quotients poison downstream conditioning); monomial
    re-injection moves (to rotate a terminal z^a phase back to z^0) are
    rationed so cycles cannot eat the depth budget.
    """
    if not budget.tick() or depth > budget.maxdepth:
        return None
    sl = budget.slack
    Q11, Q12, Q21, Q22 = (_retrim(p, sl) for p in Q)

    if Q12.zero:
        m = _monomial(Q11)
        if m is not None and m[0] == 0:
            n1 = m[1]
            m2 = _monomial(Q22)
            if m2 is None or m2[0] != 0:
                return None
            n2 = m2[1]
            out = list(steps)
            if not Q21.zero:
                # clear Q21 with one update peel: exact monomial division
                C = _LP(Q21.lo, Q21.c / n2)
                out.append(_step_of(UPDATE, -C))
                # (Q21 + Q22*C = 0 with C = -Q21/n2; _step_of records the
                # forward step whose inverse-peel used +C, see below)
            budget.found.append((out, n1, n2))
            return None

    moves = []

    def score(r, C):
        cm = float(np.abs(C.c).max()) if len(C.c) else 0.0
        return r.norm() * (1.0 + 0.03 * cm) + 1e-3 * cm

    if not Q11.zero and not Q12.zero:
        for q, r in _divmod_variants(Q12, Q11):
            if q.zero:
                continue
            C = -q
            moves.append((score(r, C), PREDICT, C,
                          (Q11, r, Q21, Q22 + Q21 * C), injects))
        for q, r in _divmod_variants(Q11, Q12):
            if q.zero:
                continue
            C = -q
            moves.append((score(r, C), UPDATE, C,
                          (r, Q12, Q21 + Q22 * C, Q22), injects))
    # monomial re-injection and constant pivots: the three-peel gadget
    # that turns a terminal [[c z^a, 0], [u, v]] phase monomial into
    # constants (the diag(z^a, z^-a) "scaling step" of D&S section 7.3):
    # inject makes the opposite entry a constant; the const-pivot then
    # rewrites the whole other entry to 1 in one peel (exact division by
    # a constant — NOT a span-reducing Euclidean move, so it is rationed
    # with the inject budget); an ordinary division then clears the rest.
    if injects > 0:
        one = _LP(0, [1.0])
        if Q11.zero:
            m = _monomial(Q12)
            if m is not None:
                C = _LP(-m[0], [1.0 / m[1]])
                moves.append((1.0, UPDATE, C,
                              (Q11 + Q12 * C, Q12, Q21 + Q22 * C, Q22),
                              injects - 1))
        if Q12.zero:
            m = _monomial(Q11)
            if m is not None and m[0] != 0:
                C = _LP(-m[0], [1.0 / m[1]])
                moves.append((1.0, PREDICT, C,
                              (Q11, Q12 + Q11 * C, Q21, Q22 + Q21 * C),
                              injects - 1))
        c12 = _monomial(Q12)
        if c12 is not None and c12[0] == 0 and Q11.span != 1:
            C = (one - Q11) * _LP(0, [1.0 / c12[1]])
            moves.append((1.5, UPDATE, C,
                          (one, Q12, Q21 + Q22 * C, Q22), injects - 1))
        c11 = _monomial(Q11)
        if c11 is not None and c11[0] == 0 and Q12.span != 1:
            C = (one - Q12) * _LP(0, [1.0 / c11[1]])
            moves.append((1.5, PREDICT, C,
                          (Q11, one, Q21, Q22 + Q21 * C), injects - 1))

    moves.sort(key=lambda t: t[0])
    for _rn, kind, C, Qn, inj in moves[:10]:
        _descend(Qn, steps + [_step_of(kind, C)], budget, depth + 1, inj)
        if not budget.tick():
            break
    return None


def polyphase(h: np.ndarray):
    """Analysis polyphase matrix (He, Ho, Go, Ge) of an l2-normalized
    orthogonal scaling filter under this engine's conventions."""
    h = np.asarray(h, np.float64)
    he = _LP(0, h[0::2])
    ho = _LP(0, h[1::2])
    n_e = len(h[0::2])
    n_o = len(h[1::2])
    ge = _LP(-(n_e - 1), h[0::2][::-1])
    go = _LP(-(n_o - 1), -h[1::2][::-1])
    return he, ho, go, ge


def _verify(h: np.ndarray, steps, n1: float, n2: float) -> float:
    """Max-abs error of the reconstructed polyphase matrix vs the
    filter's."""
    one = _LP(0, [1.0])
    zero = _LP(0, [])
    Q = (one, zero, zero, one)
    for st in steps:
        C = _LP(-st.shift, st.coef)
        a, b, c, d = Q
        if st.kind == PREDICT:
            # forward predict: [s; d] <- [[1, -C], [0, 1]] [s; d]
            Q = (a - C * c, b - C * d, c, d)
        else:
            Q = (a, b, c - C * a, d - C * b)
    a, b, c, d = Q
    sc = _LP(0, [n1])
    sd = _LP(0, [n2])
    Q = (sc * a, sc * b, sd * c, sd * d)
    err = 0.0
    for got, want in zip(Q, polyphase(h)):
        err = max(err, (got - want).norm())
    return err


_CACHE: dict = {}


def lifting_factorization(h, name: str = "?"):
    """(steps, norm1, norm2) such that the GLS forward reproduces the
    filter-bank forward of the l2-normalized filter ``h`` exactly (f64).

    Raises ValueError when no exact factorization exists — e.g. the
    truncated Battle-Lemarie tables, which are only approximately
    orthogonal, so det P != 1 and the Euclidean descent cannot
    terminate on a constant diagonal."""
    key = tuple(np.asarray(h, np.float64).tolist())
    if key in _CACHE:
        return _CACHE[key]
    he, ho, go, ge = polyphase(np.asarray(h, np.float64))
    # Orthonormality defect: several published tables (coif*, sym9/10,
    # vaid) carry only ~8 significant digits, so det P = 1 + eps with
    # eps ~ 1e-7.  The Euclidean descent still terminates (generic
    # Laurent pairs are coprime) and the resulting scheme is STILL
    # exactly invertible (every lifting step is), it just reproduces the
    # filter bank only to O(eps) — the same defect the filter bank's own
    # adjoint "inverse" has.  Beyond _DEFECT_MAX (the truncated
    # Battle-Lemarie IIR tables, eps ~ 1e-3) we refuse.
    det = he * ge - ho * go
    one = _LP(0, [1.0])
    defect = (det - one).norm()
    if defect > _DEFECT_MAX:
        raise ValueError(
            f"no lifting factorization for {name!r}: the filter is not "
            f"orthonormal (polyphase determinant defect {defect:.2e}; "
            "e.g. the Battle-Lemarie tables are truncated IIR filters) — "
            "use transform='filter'")
    # iterative deepening over (inject budget, depth), collecting a pool
    # of candidate factorizations and keeping the best-conditioned one
    # (smallest verification error, then smallest coefficients)
    taps = len(key)
    cands = []
    slack = max(_TOL, 100.0 * defect)
    for inj, maxd, want in ((0, taps + 8, 24), (2, taps + 14, 16),
                            (4, 2 * taps + 16, 8), (8, 64, 4)):
        b = _Budget(120000, maxd, want, slack)
        _descend((he, ho, go, ge), [], b, 0, injects=inj)
        cands.extend(b.found)
        if any(_verify(h, *c) <= max(1e-10, 4.0 * defect)
               for c in b.found):
            break
    if not cands:
        raise ValueError(
            f"lifting factorization search failed for {name!r}")

    def rank(c):
        """Order-of-magnitude of the reconstruction error first (errors
        below the table defect are all equivalent), then the cascade
        gain: the factored steps only compose to a bounded operator
        through CANCELLATION, and both f32 round-trip precision and the
        non-periodic boundary modes (which perturb the cancellation at
        the edges) degrade with the worst-case intermediate growth
        prod(1 + sum|coef|)."""
        steps, _n1, _n2 = c
        err = max(_verify(h, *c), 10.0 * defect, 1e-14)
        return (int(np.ceil(np.log10(err))), cascade_gain(steps),
                len(steps))

    steps, n1, n2 = min(cands, key=rank)
    err = _verify(h, steps, n1, n2)
    if err > max(1e-8, 50.0 * defect):
        raise ValueError(
            f"lifting factorization of {name!r} failed verification "
            f"(reconstruction error {err:.2e})")
    out = (tuple(steps), float(n1), float(n2))
    _CACHE[key] = out
    return out
