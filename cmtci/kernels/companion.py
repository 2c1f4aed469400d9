"""Batched inverse-eigenvalue clouds of generalized Lucas companion matrices.

Reference behavior (NOT copied; reimplemented for the device):
  * companion matrix with given first row and ones on the subdiagonal —
    ``lucas_equipotential_test_v3.py:58-74``, ``tci_construct_mandelbrot_v002_fixed.py:24-25``
  * the four top-row families — ``lucas_equipotential_test_v3.py:76-91``
  * inverse-eigenvalue cloud {1/λ, |λ|>tol} concatenated over n —
    ``lucas_equipotential_test_v3.py:93-118``, ``tci_construct_mandelbrot_v002_fixed.py:27-33``

Device-first design: the eigenvalues of a companion matrix with first row
(c_1..c_n) are exactly the roots of  p(x) = x^n - c_1 x^{n-1} - ... - c_n.
Instead of porting a dense LAPACK eigensolve (CPU-only in JAX) we solve the
polynomial directly with a **batched Aberth–Ehrlich simultaneous root
iteration**: pure elementwise work over (batch, lane) arrays, float64
(complex as (re, im) pairs, one code path on every backend), fixed shapes with
validity masks, `lax.while_loop` until converged. LAPACK on host remains
available as a parity oracle (``backend="lapack"``).

Numerical stability for degrees up to ~1220: Newton ratios p/p' are evaluated
in two branches — a reversed-polynomial (in u = 1/z) Horner for |z| > 1.25 and
a padded direct Horner for |z| <= 1.25 — so nothing overflows even though
x^1220 would. Zero-padding of coefficients is exact in both branches (the
padded direct polynomial is z^(L-deg) * p(z); its extra log-derivative term
(L-deg)/z is subtracted analytically).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cmtci.utils import cplx

FAMILIES = (
    "lucas_all_ones",
    "pell_like_all_twos",
    "sparser_gap_1_0_1_then_ones",
    "padovan_like_0_1_then_ones",
)

# Branch-switch radius for the two Horner evaluations.
_R_SWITCH2 = 1.25 * 1.25


def family_top_row(name: str, n: int) -> np.ndarray:
    """First row of the generalized companion matrix (host).

    Matches the reference families at lucas_equipotential_test_v3.py:76-91.
    """
    if name == "lucas_all_ones":
        return np.ones(n)
    if name == "pell_like_all_twos":
        return 2.0 * np.ones(n)
    if name == "sparser_gap_1_0_1_then_ones":
        top = np.ones(n)
        if n >= 2:
            top[1] = 0.0
        return top
    if name == "padovan_like_0_1_then_ones":
        top = np.ones(n)
        top[0] = 0.0
        return top
    raise ValueError(f"Unknown family '{name}'")


def companion_matrix(top: np.ndarray) -> np.ndarray:
    """Dense companion matrix (host; parity oracle only)."""
    top = np.asarray(top, dtype=float).reshape(-1)
    n = top.shape[0]
    c = np.zeros((n, n))
    c[0, :] = top
    c[1:, :-1] += np.eye(n - 1)
    return c


def poly_coeff_batch(ns, family: str = "lucas_all_ones"):
    """Padded ascending coefficient batch for the char polys of `ns`.

    Returns (a, deg): a[b, k] is the coefficient of u^k in
    q_b(u) = 1 - sum_k c_k u^k  (i.e. a[b,0]=1, a[b,k]=-c_k for k<=n_b),
    zero-padded to the max degree. deg[b] = n_b.
    """
    ns = [int(n) for n in ns]
    lmax = max(ns)
    a = np.zeros((len(ns), lmax + 1))
    a[:, 0] = 1.0
    for b, n in enumerate(ns):
        a[b, 1 : n + 1] = -family_top_row(family, n)
    return jnp.asarray(a), jnp.asarray(ns, dtype=jnp.int32)


def _horner_pair(a, z, reverse: bool):
    """Simultaneous Horner of the polynomial and its derivative.

    a: (B, L+1) real coefficients, ascending in u.
    z: pair of (B, nL) arrays.
    reverse=False evaluates P(x) = sum_k a_k x^(L-k) (descending; padded
    direct form); reverse=True evaluates q(u) = sum_k a_k u^k by iterating
    coefficients high-to-low. Returns (val_pair, deriv_pair).
    """
    big_l = a.shape[1] - 1
    zero = jnp.zeros_like(z[0])

    def body(i, carry):
        p_r, p_i, d_r, d_i = carry
        k = big_l - i if reverse else i
        ak = jax.lax.dynamic_slice_in_dim(a, k, 1, axis=1)  # (B, 1)
        d = cplx.add(cplx.mul((d_r, d_i), z), (p_r, p_i))
        p = cplx.add(cplx.mul((p_r, p_i), z), (ak + zero, zero))
        return p[0], p[1], d[0], d[1]

    init = (zero, zero, zero, zero)
    p_r, p_i, d_r, d_i = jax.lax.fori_loop(0, big_l + 1, body, init)
    return (p_r, p_i), (d_r, d_i)


def _newton_ratio(a, deg, z):
    """w = p(z)/p'(z) for the charpoly, stable for any |z|. Pair in/out.

    Both branches are written so that w -> 0 smoothly as z approaches a root
    (no intermediate infinities when p(z) == 0 exactly):
      outside: w = z*q / (deg*q - u*q')        with u = 1/z
      inside:  w = z*P / (z*P' - pad*P)        with P = z^pad * p
    """
    big_l = a.shape[1] - 1
    degf = _re_pair(deg[:, None].astype(z[0].dtype))
    outside = cplx.abs2(z) > _R_SWITCH2

    # --- outside branch: reversed polynomial in u = 1/z
    u = cplx.where(outside, cplx.reciprocal(z), cplx.full_like(z, 0.5))
    q, qp = _horner_pair(a, u, reverse=True)
    num_out = cplx.mul(z, q)
    den_out = cplx.sub(cplx.mul(degf, q), cplx.mul(u, qp))

    # --- inside branch: padded direct P(z) = z^(L-deg) p(z)
    z_in = cplx.where(outside, cplx.full_like(z, 0.5), z)
    p, pp = _horner_pair(a, z_in, reverse=False)
    pad = _re_pair(big_l - degf[0])
    num_in = cplx.mul(z_in, p)
    den_in = cplx.sub(cplx.mul(z_in, pp), cplx.mul(pad, p))

    num = cplx.where(outside, num_out, num_in)
    den = cplx.where(outside, den_out, den_in)
    den2 = cplx.abs2(den)
    safe = den2 > 0
    den2 = jnp.where(safe, den2, 1.0)
    w = ((num[0] * den[0] + num[1] * den[1]) / den2,
         (num[1] * den[0] - num[0] * den[1]) / den2)
    return cplx.where(safe, w, cplx.full_like(z, 0.0))


def _re_pair(x):
    return x, jnp.zeros_like(x)


def _pow_int(z, n, nbits: int = 12):
    """z**n elementwise by binary exponentiation; n an int array (per row).

    12 bits covers n < 4096; |z| <= 1.25 keeps the largest repeated square
    (1.25^2048 ~ 1e198) inside f64 range, and |u| < 0.8 underflows to the
    correct 0 limit. O(log n) complex muls replace the O(n) Horner sweep.
    """
    acc = cplx.full_like(z, 1.0)
    base = z
    for i in range(nbits):
        bit = ((n >> i) & 1) > 0
        acc = cplx.where(bit, cplx.mul(acc, base), acc)
        if i + 1 < nbits:
            base = cplx.mul(base, base)
    return acc


# Closed-form numerators of q(u) = 1 - sum_k c_k u^k for the four reference
# top-row families (lucas_equipotential_test_v3.py:76-91): each is a
# geometric series, so q(u) = (P(u) + a*u^(n+1)) / (1 - u) with deg(P) <= 3.
# (P ascending coefficients, a) per family:
_CLOSED_FAMILIES = {
    "lucas_all_ones": ((1.0, -2.0), 1.0),
    "pell_like_all_twos": ((1.0, -3.0), 2.0),
    "sparser_gap_1_0_1_then_ones": ((1.0, -2.0, 1.0, -1.0), 1.0),
    "padovan_like_0_1_then_ones": ((1.0, -1.0, -1.0), 1.0),
}


def _poly_eval_small(coeffs, z):
    """P(z) and P'(z) for a tiny ascending-coefficient real polynomial."""
    p = cplx.full_like(z, 0.0)
    d = cplx.full_like(z, 0.0)
    for c in reversed(coeffs):
        d = cplx.add(cplx.mul(d, z), p)
        p = cplx.add(cplx.mul(p, z), _re_pair(c + jnp.zeros_like(z[0])))
    return p, d


def _newton_ratio_closed(family: str, deg, z):
    """w = p(z)/p'(z) via the family's closed form; O(log n) per lane.

    Outside (|z| > 1.25, u = 1/z):  with M(u) = P(u) + a*u^(n+1),
      q = M/(1-u), q' = (M'(1-u) + M)/(1-u)^2, and the reversed-form Newton
      ratio w = z*q / (n*q - u*q') becomes
      w = z*M*(1-u) / (n*M*(1-u) - u*(M'*(1-u) + M)).
    Inside: with N(z) = z^(n+1)*P(1/z) + a = z^(n-dP)*(z^dP*P(1/z)... )
      evaluated as N = z^(n+1-dP) * Prev(z) + a  (Prev = reversed P) and
      p = N/(z-1):  w = N*(z-1) / (N'*(z-1) - N).
    Two-branch structure like the generic Horner, but the switch radius is
    DEGREE-AWARE: the inside branch forms products ~ |z|^(2n)·n², so
    r = min(1.25, 10^(140/n)) keeps them inside f64 range (without it,
    deg >~ 1550 silently overflowed to NaN lanes near |z|=1.25 — inf/inf in
    the Newton ratio — which never converge). Outside-branch u^n then
    underflows to the correct 0 for |u| < 1/r.
    """
    coeffs, a_const = _CLOSED_FAMILIES[family]
    degf = _re_pair(deg[:, None].astype(z[0].dtype))
    r_sw = jnp.minimum(1.25, 10.0 ** (140.0 / jnp.maximum(degf[0], 1.0)))
    outside = cplx.abs2(z) > r_sw * r_sw

    # --- outside branch (u = 1/z)
    u = cplx.where(outside, cplx.reciprocal(z), cplx.full_like(z, 0.5))
    p_u, dp_u = _poly_eval_small(coeffs, u)
    un = _pow_int(u, deg[:, None])  # u^n
    un1 = cplx.mul(un, u)
    m = cplx.add(p_u, cplx.scale(un1, a_const))
    # M' = P' + a*(n+1)*u^n
    np1 = cplx.add(degf, (jnp.ones_like(z[0]), jnp.zeros_like(z[0])))
    mp = cplx.add(dp_u, cplx.scale(cplx.mul(np1, un), a_const))
    one_mu = cplx.sub(cplx.full_like(z, 1.0), u)
    m_omu = cplx.mul(m, one_mu)
    num_out = cplx.mul(z, m_omu)
    den_out = cplx.sub(cplx.mul(degf, m_omu),
                       cplx.mul(u, cplx.add(cplx.mul(mp, one_mu), m)))

    # --- inside branch: N(z) = z^(n+1-dP) * Prev(z) + a with
    # Prev(z) = sum_j coeffs[j] z^(dP-j) (the reversed small polynomial)
    dp_small = len(coeffs) - 1
    rev = tuple(reversed(coeffs))
    z_in = cplx.where(outside, cplx.full_like(z, 0.5), z)
    prev, dprev = _poly_eval_small(rev, z_in)
    k_exp = deg[:, None] + (1 - dp_small)  # n+1-dP (>= 0 for n >= dP)
    zk = _pow_int(z_in, jnp.maximum(k_exp, 0))
    n_big = cplx.add(cplx.mul(zk, prev), cplx.full_like(z, a_const))
    # N' = k*z^(k-1)*Prev + z^k*Prev' = z^(k-1)*(k*Prev + z*Prev') for k >= 1;
    # for k == 0 (n = deg(P)-1, the smallest degrees) N' is just Prev'.
    kf = _re_pair(k_exp.astype(z[0].dtype) + jnp.zeros_like(z[0]))
    zk1 = _pow_int(z_in, jnp.maximum(k_exp - 1, 0))
    n_prime = cplx.mul(zk1, cplx.add(cplx.mul(kf, prev), cplx.mul(z_in, dprev)))
    n_prime = cplx.where((k_exp == 0) + jnp.zeros_like(z[0], dtype=bool), dprev, n_prime)
    zm1 = cplx.sub(z_in, cplx.full_like(z, 1.0))
    num_in = cplx.mul(n_big, zm1)
    den_in = cplx.sub(cplx.mul(n_prime, zm1), n_big)

    num = cplx.where(outside, num_out, num_in)
    den = cplx.where(outside, den_out, den_in)
    den2 = cplx.abs2(den)
    safe = den2 > 0
    den2 = jnp.where(safe, den2, 1.0)
    w = ((num[0] * den[0] + num[1] * den[1]) / den2,
         (num[1] * den[0] - num[0] * den[1]) / den2)
    return cplx.where(safe, w, cplx.full_like(z, 0.0))


# Curve init is asymptotic in n; below this degree the unit-circle init is
# both safer (sparser/padovan lost ~5 digits at n<=5) and just as fast.
_CURVE_INIT_MIN_DEG = 16


def _small_poly_on(coeffs, e):
    """P(e) for a tiny ascending-coefficient real polynomial, pair input."""
    p = cplx.full_like(e, 0.0)
    for c in reversed(coeffs):
        p = cplx.add(cplx.mul(p, e), _re_pair(c + jnp.zeros_like(e[0])))
    return p


def _curve_init(family: str, deg, nl: int, dtype):
    """Structured Aberth init for the closed-form families (2-3 iterations
    at stage-4 shapes vs 15-18 from the unit circle — the iteration count,
    not the per-iteration cost, was the eigensweep's dominant remaining
    factor; lucas_equipotential_test_v3.py:93-118 is the behavior served).

    Root structure of M(u) = P(u) + a·u^{n+1} (q = M/(1-u), roots λ = 1/u):
      * ndom dominant eigenvalues λ ≈ 1/u_P at the P-roots inside the disk
        (λ≈2 for Lucas) — a·u^{n+1} is exponentially negligible there;
      * the phantom u=1 (the removed 1-u factor; P(1)+a = 0 by
        construction for every all-ones-tail family);
      * n-ndom roots exponentially close to the curve |u|^{n+1} = |P(u)|/a,
        with phases at the slots  θ·(n+1-ndom) = 2πk + η(θ),  where
        η = arg((-P(e^{iθ})/a)·e^{-i·ndom·θ}) is the winding-removed
        residual phase (numerically verified wrap-free, |η| ≤ 1.11, for
        all four reference families). k = 1..n-ndom skips the phantom.

    One η evaluation at the uncorrected slot registers every lane to its
    own root basin (without it, lanes misregister by up to half a slot and
    ~40 stragglers shuffle for 25+ extra iterations). λ = (1/s)e^{-iθ} with
    s = (|P|/a)^{1/(n+1)}; the last ndom valid lanes take the dominant
    points. Rows with deg < _CURVE_INIT_MIN_DEG keep the circle init.
    """
    coeffs, a_const = _CLOSED_FAMILIES[family]
    proots = np.roots(list(reversed(coeffs)))
    dom = [1.0 / r for r in proots if abs(r) < 0.9]
    ndom = len(dom)

    lane = jnp.arange(nl)[None, :]
    degf = jnp.maximum(deg, 1)[:, None].astype(dtype)
    k = lane + 1.0
    denom = jnp.maximum(degf + 1.0 - float(ndom), 1.0)
    theta = 2.0 * jnp.pi * k / denom
    e = (jnp.cos(theta), jnp.sin(theta))
    mp = cplx.scale(_small_poly_on(coeffs, e), -1.0 / a_const)  # -P/a
    # winding-removed residual R = (-P/a)·e^{-i·ndom·θ}
    r = mp
    for _ in range(ndom):
        r = cplx.mul(r, (e[0], -e[1]))
    eta = jnp.arctan2(r[1], r[0])
    theta = (2.0 * jnp.pi * k + eta) / denom
    e = (jnp.cos(theta), jnp.sin(theta))
    mp = cplx.scale(_small_poly_on(coeffs, e), -1.0 / a_const)
    s = jnp.sqrt(jnp.maximum(cplx.abs2(mp), 1e-300)) ** (1.0 / (degf + 1.0))
    z = ((1.0 / s) * e[0], -(1.0 / s) * e[1])
    # last ndom valid lanes -> the dominant points
    for i, lam in enumerate(dom):
        is_dom = lane == (deg[:, None] - 1 - i)
        z = (jnp.where(is_dom, float(np.real(lam)), z[0]),
             jnp.where(is_dom, float(np.imag(lam)), z[1]))
    # small-degree rows: keep the circle init
    theta_c = 2.0 * jnp.pi * (lane + 0.256) / degf + 0.577 / degf
    small = (deg[:, None] < _CURVE_INIT_MIN_DEG) | jnp.zeros_like(z[0], bool)
    return (jnp.where(small, jnp.cos(theta_c), z[0]),
            jnp.where(small, jnp.sin(theta_c), z[1]))


def _pairwise_repulsion(z, valid, chunk: int):
    """S_i = sum_{j != i, valid_j} 1/(z_i - z_j), blocked over j to bound memory."""
    nl = z[0].shape[1]
    nl_pad = ((nl + chunk - 1) // chunk) * chunk
    pad = nl_pad - nl
    zr = jnp.pad(z[0], ((0, 0), (0, pad)))
    zi = jnp.pad(z[1], ((0, 0), (0, pad)))
    vp = jnp.pad(valid, ((0, 0), (0, pad)))
    lane = jnp.arange(nl)[None, :]

    def body(c, carry):
        s_r, s_i = carry
        j0 = c * chunk
        zjr = jax.lax.dynamic_slice_in_dim(zr, j0, chunk, axis=1)
        zji = jax.lax.dynamic_slice_in_dim(zi, j0, chunk, axis=1)
        vj = jax.lax.dynamic_slice_in_dim(vp, j0, chunk, axis=1)
        jdx = j0 + jnp.arange(chunk)[None, :]
        dr = z[0][:, :, None] - zjr[:, None, :]
        di = z[1][:, :, None] - zji[:, None, :]
        d2 = dr * dr + di * di
        mask = vj[:, None, :] & (lane[:, :, None] != jdx[:, None, :])
        inv = jnp.where(mask & (d2 > 0), 1.0 / jnp.where(d2 > 0, d2, 1.0), 0.0)
        return s_r + jnp.sum(dr * inv, axis=2), s_i + jnp.sum(-di * inv, axis=2)

    zero = jnp.zeros_like(z[0])
    return jax.lax.fori_loop(0, nl_pad // chunk, body, (zero, zero))


@functools.partial(jax.jit,
                   static_argnames=("max_iters", "chunk", "return_info", "family",
                                    "repulsion_dtype"))
def aberth_roots(a, deg, max_iters: int = 200, tol: float = 1e-13, chunk: int = 128,
                 return_info: bool = False, family: str | None = None,
                 repulsion_dtype=jnp.float32):
    """Batched Aberth–Ehrlich root finder.

    a: (B, L+1) ascending coefficients (see poly_coeff_batch); deg: (B,).
    Returns (re, im, valid): (B, L) roots with valid[b, k] = k < deg[b].
    With return_info=True additionally returns (iterations, converged) —
    converged is False if any valid lane was still moving more than
    tol*|root| when max_iters was reached.

    When `family` names one of the closed-form families, the Newton ratio
    uses the O(log n) geometric-series form (_newton_ratio_closed) instead
    of the O(n) Horner sweep — ~5x on the tracker's stage-4 eigensweep.

    The pairwise repulsion runs in `repulsion_dtype` (default f32): it only
    conditions the simultaneous convergence — the fixed point is where the
    full-precision Newton ratio w vanishes, so the final roots keep f64
    accuracy (n=1220 vs LAPACK: 9.9e-14, same iteration count) while the
    bandwidth-bound O(L^2) term halves (6.8 s -> 2.5 s at stage-4 shapes).
    Pass repulsion_dtype=None to keep it in the input dtype.
    """
    bsz, lp1 = a.shape
    nl = lp1 - 1
    lane = jnp.arange(nl)[None, :]
    valid = lane < deg[:, None]

    if family in _CLOSED_FAMILIES:
        # structured init on the known root curve (~2x fewer iterations)
        z = _curve_init(family, deg, nl, a.dtype)
    else:
        # distinct angles on a unit-ish circle, golden-ratio phase offset
        degf = jnp.maximum(deg, 1)[:, None].astype(a.dtype)
        theta = 2.0 * jnp.pi * (lane + 0.256) / degf + 0.577 / degf
        r0 = 1.0
        z = (r0 * jnp.cos(theta), r0 * jnp.sin(theta))
    # Park invalid lanes far away so they never interact with valid ones.
    far = (1e9 * jnp.cos(lane + jnp.zeros((bsz, 1))), 1e9 * jnp.sin(lane + jnp.zeros((bsz, 1))))
    z = cplx.where(valid, z, far)

    tol2 = tol * tol

    def cond(state):
        _, _, _, it, done = state
        return jnp.logical_and(it < max_iters, jnp.logical_not(done))

    def body(state):
        zr, zi, frozen, it, _ = state
        z = (zr, zi)
        if family in _CLOSED_FAMILIES:
            w = _newton_ratio_closed(family, deg, z)
        else:
            w = _newton_ratio(a, deg, z)
        if repulsion_dtype is not None and repulsion_dtype != a.dtype:
            z_rep = (zr.astype(repulsion_dtype), zi.astype(repulsion_dtype))
            s32 = _pairwise_repulsion(z_rep, valid, chunk)
            s = (s32[0].astype(a.dtype), s32[1].astype(a.dtype))
        else:
            s = _pairwise_repulsion(z, valid, chunk)
        denom = cplx.sub(cplx.full_like(z, 1.0), cplx.mul(w, s))
        corr = cplx.div(w, denom)
        moved2 = cplx.abs2(corr)
        # latch convergence permanently: a lane that once reached the tol is
        # frozen (a no-op for well-behaved lanes, whose correction was zeroed
        # anyway; prevents ill-conditioned lanes near the closed-form noise
        # floor from re-tripping the check and pinning the loop to max_iters)
        frozen = frozen | (moved2 <= tol2 * jnp.maximum(cplx.abs2(z), 1e-30))
        corr = cplx.where(valid & ~frozen, corr, cplx.full_like(z, 0.0))
        z_new = cplx.sub(z, corr)
        done = jnp.all(jnp.where(valid, frozen, True))
        return z_new[0], z_new[1], frozen, it + 1, done

    zr, zi, _, iters, done = jax.lax.while_loop(
        cond, body,
        (z[0], z[1], jnp.zeros_like(valid), jnp.int32(0), jnp.bool_(False)),
    )
    if return_info:
        return zr, zi, valid, iters, done
    return zr, zi, valid


def _closed_form_ok(ns, family: str) -> bool:
    """Closed-form eligibility: the geometric-series identity assumes the
    family's FULL top-row pattern (sparser's c_2=0 only exists for n >= 2,
    so n=1 falls back to Horner) and _pow_int's 12-bit exponent (n < 4096;
    1.25^4096 would also overflow f64)."""
    if family not in _CLOSED_FAMILIES:
        return False
    ns = list(ns)
    if max(ns) >= 4096:
        return False
    if family == "sparser_gap_1_0_1_then_ones" and min(ns) < 2:
        return False
    return True


def eigvals_batched(ns, family: str = "lucas_all_ones", max_iters: int = 200,
                    repulsion_dtype=jnp.float32):
    """Padded batched companion eigenvalues via Aberth. Returns (re, im, valid).

    repulsion_dtype=None opts out of the mixed-precision repulsion for
    precision-sensitive callers (all-f64 Aberth; see aberth_roots).
    """
    a, deg = poly_coeff_batch(ns, family)
    fam = family if _closed_form_ok(ns, family) else None
    return aberth_roots(a, deg, max_iters=max_iters, family=fam,
                        repulsion_dtype=repulsion_dtype)


def eigvals_bucketed(ns, family: str = "lucas_all_ones", max_iters: int = 200,
                     growth: float = 1.5, min_cap: int = 64,
                     repulsion_dtype=jnp.float32):
    """Degree-bucketed batched Aberth sweep (host-orchestrated).

    Same contract as eigvals_batched — (re, im, valid) padded to max(ns),
    rows in input order — but each polynomial is padded only to its
    bucket's max degree, so the O(L²) repulsion cost tracks Σ n² instead
    of B·n_max² (~2x at the tracker's stage-4 shapes) and small-degree
    buckets exit their while_loop independently. Worth it only when the
    padded repulsion work is large: each bucket is its own jit trace, so
    inverse_cloud_padded gates on B·n_max² > 5e7 — small dense sweeps
    (e.g. the equipotential's n=2..200, work ~8e6) stay single-batch
    where the per-bucket trace overhead would dominate the saving. Rows are solved by the identical
    aberth_roots kernel (zero-padding of coefficients is exact, see
    _newton_ratio), so per-root values equal the unbucketed sweep's up to
    the convergence tolerance. Not jit-traceable (host loop over buckets);
    use eigvals_batched / parallel.sharded_eigensweep inside jit.
    """
    ns_list = [int(n) for n in ns]
    ns_arr = np.asarray(ns_list)
    lmax = int(ns_arr.max())
    caps = []
    c = min_cap
    while c < lmax:
        caps.append(c)
        c = max(int(np.ceil(c * growth)), c + 1)
    caps.append(lmax)

    # park padding lanes far away (like aberth_roots' invalid lanes) so a
    # downstream reciprocal stays finite
    zr = np.full((len(ns_arr), lmax), 1e9)
    zi = np.zeros((len(ns_arr), lmax))
    valid = np.zeros((len(ns_arr), lmax), dtype=bool)
    lo = 0
    for cap in caps:
        idx = np.where((ns_arr > lo) & (ns_arr <= cap))[0]
        lo = cap
        if idx.size == 0:
            continue
        sub = [ns_list[i] for i in idx]
        a, deg = poly_coeff_batch(sub, family)
        fam = family if _closed_form_ok(sub, family) else None
        r_zr, r_zi, r_valid = aberth_roots(a, deg, max_iters=max_iters, family=fam,
                                           repulsion_dtype=repulsion_dtype)
        w = r_zr.shape[1]
        zr[idx, :w] = np.asarray(r_zr)
        zi[idx, :w] = np.asarray(r_zi)
        valid[idx, :w] = np.asarray(r_valid)
    return jnp.asarray(zr), jnp.asarray(zi), jnp.asarray(valid)


def _bucketing_pays(ns) -> bool:
    """Gate for the degree-bucketed sweep. Bucketing pays when either

    * the padded repulsion work is large (stage-4-scale sweeps,
      n_max ~1220), or
    * the sweep spans the curve-init threshold: rows below
      _CURVE_INIT_MIN_DEG use the circle init (~10 Aberth iterations)
      while curve-registered rows converge in ~3, and a single batch's
      while_loop runs EVERY row for the worst row's count — a dense
      n=2..200 sweep is 0.20 s single-batch vs 0.04 s bucketed
      (root-for-root equal; the small rows ride in the first bucket).

    Each bucket is its own jit trace (~0.5 s of host time per new shape,
    amortized by the persistent compile cache), so uniform small sweeps
    stay single-batch."""
    ns = [int(n) for n in ns]
    if len(set(ns)) <= 1:
        return False
    if min(ns) < _CURVE_INIT_MIN_DEG < max(ns):
        return True
    return len(ns) * max(ns) ** 2 > 5e7


def inverse_cloud_padded(ns, family: str = "lucas_all_ones",
                         bucketed: bool = True, repulsion_dtype=jnp.float32):
    """Padded inverse-eigenvalue cloud 1/λ. Returns (re, im, valid).

    bucketed=True (host paths) runs the degree-bucketed sweep; pass False
    where a single traced kernel is required.
    """
    ns = [int(n) for n in ns]
    if bucketed and _bucketing_pays(ns):
        zr, zi, valid = eigvals_bucketed(ns, family, repulsion_dtype=repulsion_dtype)
    else:
        zr, zi, valid = eigvals_batched(ns, family, repulsion_dtype=repulsion_dtype)
    inv = cplx.reciprocal((zr, zi))
    return inv[0], inv[1], valid


def inverse_cloud_split(
    ns,
    family: str = "lucas_all_ones",
    tol: float = 1e-10,
    backend: str = "aberth",
    repulsion_dtype=jnp.float32,
) -> list:
    """Per-n list of inverse-eigenvalue clouds (one complex128 array per n).

    np.concatenate of the result IS inverse_cloud(...) — one shared
    construction, so pipelines that need both the flat cloud and the per-n
    split (equipotential per-n/cumulative stats) solve the eigenproblem and
    any downstream per-point kernel once.
    """
    if backend == "lapack":
        pts = []
        for n in ns:
            vals = np.linalg.eigvals(companion_matrix(family_top_row(family, n)))
            vals = vals[np.abs(vals) > tol]
            pts.append(1.0 / vals)
        return pts

    zr, zi, valid = inverse_cloud_padded(ns, family,
                                         repulsion_dtype=repulsion_dtype)
    lam2 = 1.0 / (np.asarray(zr) ** 2 + np.asarray(zi) ** 2 + 1e-300)  # |λ|² of padded 1/λ
    keep = np.asarray(valid) & (lam2 > tol * tol)
    z = np.asarray(zr) + 1j * np.asarray(zi)
    return [z[b][keep[b]] for b in range(z.shape[0])]


def inverse_cloud(
    ns,
    family: str = "lucas_all_ones",
    tol: float = 1e-10,
    backend: str = "aberth",
    repulsion_dtype=jnp.float32,
) -> np.ndarray:
    """Host complex128 inverse-eigenvalue cloud, concatenated over ns.

    Matches tci_construct_mandelbrot_v002_fixed.py:27-33 semantics
    (drop |λ| <= tol, then invert). backend="lapack" reproduces the
    reference's exact per-n LAPACK ordering for bitwise parity runs.
    """
    return np.concatenate(inverse_cloud_split(ns, family, tol=tol,
                                              backend=backend,
                                              repulsion_dtype=repulsion_dtype))
