"""Diffusion-map style spectral embeddings of point clouds (T16).

Reference: dynamical_embeddings_phase7.py:42-102 — sparse kNN gaussian
kernel (k=20, sigma = eps_scale * median kNN distance), symmetrize, row-
normalize to a Markov matrix, top-n_eigs eigenpairs of the symmetrized P,
and an L2 spectral distance on leading eigenvalues.

Device-first: the kNN search is a blocked dense top-k on device (the clouds
are <=150k points, 2-D); the small eigenproblem runs via scipy eigsh on the
sparse symmetrized Markov matrix (host) with a dense jnp.linalg.eigh path
for small n.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.linalg import eigsh


from cmtci.utils.arrays import as_xy as _xy  # shared (N,2) coercion
from cmtci.utils.device import highest_precision


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _knn(xy, k: int, chunk: int = 2048):
    """(distances, indices) of the k nearest neighbors excluding self."""
    n = xy.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    xp = jnp.pad(xy, ((0, npad - n), (0, 0)), constant_values=jnp.inf)

    def body(i, acc):
        dists, idxs = acc
        blk = jax.lax.dynamic_slice_in_dim(xp, i * chunk, chunk, axis=0)
        ridx = i * chunk + jnp.arange(chunk)
        d2 = jnp.sum((blk[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(ridx[:, None] == jnp.arange(n)[None, :], jnp.inf, d2)  # drop self
        negd, nbr = jax.lax.top_k(-d2, k)
        dists = jax.lax.dynamic_update_slice_in_dim(dists, jnp.sqrt(-negd), i * chunk, axis=0)
        idxs = jax.lax.dynamic_update_slice_in_dim(idxs, nbr, i * chunk, axis=0)
        return dists, idxs

    dists = jnp.zeros((npad, k), dtype=xy.dtype)
    idxs = jnp.zeros((npad, k), dtype=jnp.int32)
    dists, idxs = jax.lax.fori_loop(0, npad // chunk, body, (dists, idxs))
    return dists[:n], idxs[:n]


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _knn_hilo(hi, lo, k: int, chunk: int = 2048):
    """f32 kNN candidate search with hi/lo two-float coordinates.

    Plain f32 coordinates collapse near-duplicate points (the inverse-
    eigenvalue clouds carry ~1e-11 spacings) onto the same value, so the
    candidate set within such a cluster is arbitrary. Splitting each f64
    coordinate as hi = f32(x), lo = f32(x - hi) makes the block difference
    (hi_j - hi_i) exact for close points (Sterbenz) and (dh + dl) accurate
    to ~1e-14 relative — the same pair-arithmetic idea as the Pallas
    (re,im) kernels. Returns candidate indices (n, k)."""
    n = hi.shape[0]
    npad = ((n + chunk - 1) // chunk) * chunk
    hp = jnp.pad(hi, ((0, npad - n), (0, 0)), constant_values=jnp.inf)
    lp = jnp.pad(lo, ((0, npad - n), (0, 0)))

    def body(i, idxs):
        bh = jax.lax.dynamic_slice_in_dim(hp, i * chunk, chunk, axis=0)
        bl = jax.lax.dynamic_slice_in_dim(lp, i * chunk, chunk, axis=0)
        ridx = i * chunk + jnp.arange(chunk)
        dx = (bh[:, None, :] - hi[None, :, :]) + (bl[:, None, :] - lo[None, :, :])
        d2 = jnp.sum(dx * dx, axis=-1)
        d2 = jnp.where(ridx[:, None] == jnp.arange(n)[None, :], jnp.inf, d2)
        _, nbr = jax.lax.top_k(-d2, k)
        return jax.lax.dynamic_update_slice_in_dim(idxs, nbr, i * chunk, axis=0)

    idxs = jnp.zeros((npad, k), dtype=jnp.int32)
    return jax.lax.fori_loop(0, npad // chunk, body, idxs)[:n]


def build_sparse_kernel(points, k: int = 20, eps_scale: float = 0.5, mesh=None,
                        dtype=None):
    """Symmetric sparse gaussian kNN kernel; returns (K csr, sigma).

    With a `mesh`, the kNN query rows are sharded over the devices
    (parallel.sharded.sharded_knn, bitwise-identical per row).
    dtype=jnp.float32 runs the blocked kNN SEARCH on the default device
    (the f64 host scan is the embeddings pipeline's wall at 5k+ points on
    a 1-core host: 4.6 s vs ~0.1 s) with hi/lo two-float coordinates
    (_knn_hilo — resolves the clouds' ~1e-11 near-duplicate spacings that
    plain f32 collapses) over k+8 candidates, then re-ranks the candidates
    by exact f64 distance on the host (O(n·k)) — neighbor sets match the
    f64 path unless a true kth neighbor is pushed past the 8-candidate
    margin (needs ~1e-14-relative near-ties 8 deep; exact ties can still
    resolve to a different-but-equidistant member).
    """
    xy = _xy(points)
    n = len(xy)
    if mesh is not None and dtype is not None:
        raise ValueError(
            "build_sparse_kernel: mesh and dtype are mutually exclusive — "
            "the sharded kNN is the f64 multi-device path; the f32 device "
            "path is single-device (drop one of them)")
    if mesh is not None:
        from cmtci.parallel.sharded import sharded_knn

        dists, idxs = sharded_knn(jnp.asarray(xy), int(k), mesh)
    elif dtype is not None and jnp.dtype(dtype) == jnp.float32 and n > k + 1:
        # (n <= k+1 degenerates to the exact f64 scan below: every other
        # point is a neighbor, so there is no search to accelerate)
        from cmtci.utils.device import analysis_dtype_ctx

        k_cand = min(int(k) + 8, n - 1)
        dt, x64_ctx = analysis_dtype_ctx(dtype)
        hi = xy.astype(np.float32)
        lo = (xy - hi).astype(np.float32)
        with x64_ctx:
            cand = _knn_hilo(jnp.asarray(hi, dt), jnp.asarray(lo, dt), k_cand)
        cand = np.asarray(cand)
        d2 = ((xy[cand] - xy[:, None, :]) ** 2).sum(-1)  # exact f64
        order = np.argsort(d2, axis=1, kind="stable")[:, : int(k)]
        idxs = np.take_along_axis(cand, order, axis=1)
        dists = np.sqrt(np.take_along_axis(d2, order, axis=1))
    else:

        dists, idxs = _knn(jnp.asarray(xy), int(k))
    # only the O(n²) neighbor SEARCH runs at the requested dtype; the O(nk)
    # kernel weights are always f64 — f32 exp underflows to 0 for isolated
    # points (d/σ ≳ 13), leaving zero/subnormal kernel rows whose Markov
    # normalization blows up to inf (measured: 17 such rows at a 5049-pt
    # bus) where the f64 weights are merely tiny
    dists = np.asarray(dists, dtype=np.float64)
    idxs = np.asarray(idxs)
    sigma = float(np.median(dists.ravel()) * eps_scale)
    if sigma <= 0:
        sigma = 1.0
    rows = np.repeat(np.arange(n), k)
    data = np.exp(-(dists.ravel() ** 2) / (2 * sigma * sigma))
    kmat = csr_matrix((data, (rows, idxs.ravel())), shape=(n, n))
    return 0.5 * (kmat + kmat.T), sigma


def markov_from_kernel(kmat):
    """Row-normalize to a Markov matrix (dynamical_embeddings_phase7.py:69-76)."""
    row_sum = np.asarray(kmat.sum(axis=1)).ravel()
    inv = np.divide(1.0, row_sum, out=np.zeros_like(row_sum), where=row_sum != 0)
    d_inv = csr_matrix((inv, (np.arange(len(inv)), np.arange(len(inv)))), shape=kmat.shape)
    return d_inv.dot(kmat)


@functools.partial(jax.jit, static_argnames=("m",))
@highest_precision
def _lanczos_dense(s, m: int):
    """m-step Lanczos with full reorthogonalization on a dense symmetric s.

    Dense matvecs are the device-shaped formulation (the sparse kNN matvec
    is gather/scatter-bound — same negative result as the FEM BCOO CG,
    VALIDATION.md); at the reference's cloud sizes (≤40k) the n² matvec is
    cheap. Returns (tridiag alphas (m,), betas (m-1,), basis Q (m,n)).
    """
    n = s.shape[0]
    v = jax.random.normal(jax.random.key(0), (n,), dtype=s.dtype)
    v = v / jnp.linalg.norm(v)
    q = jnp.zeros((m, n), dtype=s.dtype).at[0].set(v)

    def body(carry, j):
        q, v_prev_beta = carry
        vj = q[j]
        w = s @ vj - v_prev_beta
        alpha = w @ vj
        w = w - alpha * vj
        # full reorthogonalization against the basis built so far (masked:
        # rows > j are zero, so the projection is exact and trace-friendly)
        w = w - q.T @ (q @ w)
        beta = jnp.linalg.norm(w)
        w = w / jnp.maximum(beta, jnp.asarray(1e-30, s.dtype))
        q = jax.lax.cond(j + 1 < m, lambda q: q.at[j + 1].set(w), lambda q: q, q)
        return (q, beta * vj), (alpha, beta)

    (q, _), (alphas, betas) = jax.lax.scan(body, (q, jnp.zeros(n, s.dtype)),
                                           jnp.arange(m))
    return alphas, betas[:-1], q


def _dense_from_sparse_device(s_csr, dtype):
    """Scatter the symmetrized sparse kernel into a dense device matrix.

    Only the O(n·k) coo triplets cross the host→device link; the n² dense
    matrix is materialized device-side.
    """
    coo = s_csr.tocoo()
    n = s_csr.shape[0]
    rows = jnp.asarray(coo.row, jnp.int32)
    cols = jnp.asarray(coo.col, jnp.int32)
    data = jnp.asarray(coo.data, dtype)
    return jnp.zeros((n, n), dtype).at[rows, cols].set(data)


def spectral_embedding_device(p, n_eigs: int = 8, m: int = 0, dtype=None):
    """Device Lanczos eigenpairs of the symmetrized Markov matrix.

    The device replacement for scipy eigsh (VERDICT r3 item 6): dense
    n² matvecs + full-reorthogonalization Lanczos in one jit, tridiagonal
    eigensolve on the host (m×m, trivial). dtype=None follows x64 (f64 on a
    CPU device: eigenvalue agreement vs eigsh ≤1e-10 — pinned in tests);
    pass jnp.float32 on a GPU session (agreement ~1e-6, below the spectral
    distances the pipeline compares). Reference:
    dynamical_embeddings_phase7.py:78-102.
    """
    s = (0.5 * (p + p.T)).tocsr()
    n = s.shape[0]
    k = min(n_eigs, n - 2)
    # the symmetrized-Markov spectrum is clustered near its top, so interior
    # Ritz pairs converge slowly: m=40 leaves O(1e-2..1) errors at the
    # reference shapes, m~20k reaches machine precision (test-pinned).
    # The basis also has to GROW with n — at a 5049-pt bus m=160 leaves
    # 4.5e-3 errors where m≈n/12 reaches 2.8e-8; past that, f32
    # reorthogonalization noise re-degrades (m=800 → 1.7e-4), so cap at 600
    m = int(m) if m else min(max(20 * k, 120, min(600, n // 12)), n)
    from cmtci.utils.device import analysis_dtype_ctx

    dt, x64_ctx = analysis_dtype_ctx(dtype)
    with x64_ctx:
        sd = _dense_from_sparse_device(s, dt)
        alphas, betas, q = _lanczos_dense(sd, m)
        alphas = np.asarray(alphas, np.float64)
        betas = np.asarray(betas, np.float64)
        # tridiagonal eigensolve on host (m×m)
        t = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
        tvals, tvecs = np.linalg.eigh(t)
        order = np.argsort(np.abs(tvals))[::-1][:k]  # eigsh which="LM"
        ritz = np.asarray(q, np.float64).T @ tvecs[:, order]  # (n, k)
    vals = tvals[order]
    desc = np.argsort(vals)[::-1]
    vals = vals[desc]
    vecs = ritz[:, desc]
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0, keepdims=True), 1e-300)
    return vals, vecs


def spectral_embedding(p, n_eigs: int = 8, backend: str = "scipy", dtype=None):
    """Top eigenpairs of the symmetrized Markov matrix, descending.

    backend="scipy" is the reference-parity oracle (eigsh); "device" runs
    the blocked dense Lanczos on the default jax device."""
    if backend == "device":
        return spectral_embedding_device(p, n_eigs=n_eigs, dtype=dtype)
    s = (0.5 * (p + p.T)).tocsr()
    k = min(n_eigs, s.shape[0] - 2)
    try:
        vals, vecs = eigsh(s, k=k, which="LM")
    except Exception:
        vals_all, vecs_all = np.linalg.eigh(s.toarray())
        vals = vals_all[::-1][:n_eigs]
        vecs = vecs_all[:, ::-1][:, :n_eigs]
    order = np.argsort(vals)[::-1]
    return vals[order], vecs[:, order]


def diffusion_map(points, k: int = 20, n_eigs: int = 8, eps_scale: float = 0.5,
                  mesh=None, eig_backend: str = "scipy", eig_dtype=None,
                  knn_dtype=None):
    """Full pipeline: kernel -> Markov -> spectrum. Returns (vals, vecs, sigma)."""
    kmat, sigma = build_sparse_kernel(points, k=k, eps_scale=eps_scale, mesh=mesh,
                                      dtype=knn_dtype)
    p = markov_from_kernel(kmat)
    vals, vecs = spectral_embedding(p, n_eigs=n_eigs, backend=eig_backend,
                                    dtype=eig_dtype)
    return vals, vecs, sigma


def embedding_spectral_distance(vals_a, vals_b) -> float:
    """L2 on leading eigenvalues (dynamical_embeddings_phase7.py:169-172)."""
    n = min(len(vals_a), len(vals_b))
    return float(np.linalg.norm(np.asarray(vals_a)[:n] - np.asarray(vals_b)[:n]))
