"""Kernel C's edge cases, shared by tests/test_torch_rect_gather.py (the
plain version against the JAX package on the CPU) and
tests/test_torch_kernels.py (the kernel against the plain version and its
earlier design on the card).  Imports neither JAX nor the JAX package.

Each case is (H, W, V, K, mode): an image of H x W, V neighbour views, K
candidates' inverse depths (K = 0: one (H, W) field), and what
``edge_sigma`` does to them.
"""

import numpy as np

CASES = {
    # H, W, V and K multiples of nothing the kernel tiles by
    "61x203, K = 1": (61, 203, 3, 0, "plain"),
    "61x203, a stack of 1": (61, 203, 3, 1, "plain"),
    # one past a group of 8 candidates
    "61x331, K = 9": (61, 331, 3, 9, "plain"),
    # candidate 0 reads nothing in frame in its first tile: the tile keeps
    # the sentinel base (W_r = 1024, so the base clamps to 2, not 0)
    "a tile all out of frame": (61, 331, 3, 2, "frame_exit"),
    # view 0 reads on both sides of the frame's first and last columns
    "columns past the frame": (61, 331, 3, 3, "frame_edges"),
}
# on the card only, where the kernel runs: more views, three groups of
# candidates, a sigma that is not 16-byte aligned
GPU_CASES = {
    "V = 10": (64, 200, 10, 3, "plain"),
    "K = 17": (64, 256, 3, 17, "plain"),
    "unaligned sigma": (64, 200, 3, 2, "unaligned"),
}


def edge_sigma(c0: np.ndarray, k: np.ndarray, w_r: int, base: np.ndarray,
               mode: str) -> np.ndarray:
    """``base`` ((K, H, W) f32 inverse depths) changed for ``mode``:
    "frame_exit" sends every read of candidate 0 in the tile of rows 0-7,
    columns 0-127 out of the frame; "frame_edges" puts view 0's reads
    (its fields ``c0``, ``k`` (H, W)) in rows 8-15 on columns w_r - 3 to
    w_r + 2 and in rows 16-23 on -3 to 2, for every candidate; any other
    mode leaves it."""
    sigma = base.copy()
    if mode == "frame_exit":
        sigma[0, :8, :128] = 1e20
    elif mode == "frame_edges":
        ok = (np.abs(k) > 1e-3) & (np.abs(c0) < 1e5)
        cols = np.arange(sigma.shape[-1]) % 6
        for rows, lo in ((slice(8, 16), w_r - 3), (slice(16, 24), -3)):
            s = ((lo + cols).astype(np.float32) - c0[rows]) / np.where(
                ok[rows], k[rows], 1.0)
            sigma[:, rows] = np.where(ok[rows], s.astype(np.float32),
                                      sigma[:, rows])
    return sigma


def edge_inputs(case: str, seed: int = 8):
    """(H, W, V, K, mode, depth (V, H, W), normals (V, 3, H, W), base
    sigma (max(K, 1), H, W)), all f32 from ``seed``, of ``case`` (of
    CASES or GPU_CASES); the scene is ``make_plane_scene(default_rng(3),
    h=H, w=W, n_views=V + 1)``'s."""
    h, w, v, n_cand, mode = {**CASES, **GPU_CASES}[case]
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2.0, 6.0, (v, h, w)).astype(np.float32)
    n = rng.standard_normal((v, 3, h, w)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = (1.0 / rng.uniform(2.0, 6.0, (max(n_cand, 1), h, w))).astype(
        np.float32)
    return h, w, v, n_cand, mode, depth, n, base
