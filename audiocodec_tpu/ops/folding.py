"""Diamond fold / unfold for the MDCT polyphase filter bank.

The reference realizes the polyphase stage as a 2-tap block convolution with
*dense* [N, N] matrices H / H_inv, even though each has only 2N nonzeros in a
diamond pattern — a documented inefficiency ("todo: work out ... in more
efficient way", reference audiocodec/mdctransformer.py:16-18).

Here the diamond structure is exploited directly: folding costs exactly
**2 multiplies + 1 add per sample** (O(N) per block, bandwidth-bound,
fuses into the DCT matmul under XLA), instead of two dense [N, N] matmuls
(O(N^2) per block). The synthesis coefficients come from the analytic
inverse of the underlying 2x2 blocks — no O(N^3) matrix inverse at
construction (the reference uses tf.linalg.inv, mdctransformer.py:185).

Derivation (h = N/2; x[n] = time block n; w = window; ff = completion):

  analysis   folded[n, k]   = w[h-1-k]*x[n-1, h-1-k] + w[h+k]*x[n-1, h+k]   (k <  h)
             folded[n, h+j] = w[N+j]  *x[n,   j]     - ff[h-1-j]*x[n, N-1-j] (j < h)

which is the sparse evaluation of the reference's H-matrix product
(y[n] = x[n] @ H0 + x[n-1] @ H1 with H0/H1 the masked diamond matrix F,
reference mdctransformer.py:155-174,349-368), producing blocks+1 output
frames from blocks input frames (the reference's full-convolution padding).

  synthesis  out[n, k]   = p[h-1-k]*z[n, h-1-k] + r[k]*z[n-1, h+k]          (k <  h)
             out[n, h+j] = q[j]*z[n, j] + s[h-1-j]*z[n-1, N-1-j]            (j < h)

where (p, q, r, s) are the entries of inv(F), obtained in closed form from
the 2x2 blocks coupling rows {i, N-1-i} with columns {h-1-i, h+i} of F:

  M_i = [[w[i],     w[N+i]      ],        det_i = -w[i]*ff[h-1-i]
         [w[N-1-i], -ff[h-1-i]  ]]               - w[N+i]*w[N-1-i]

  p[a] = -ff[a]        / det_{h-1-a}      q[a] = -w[N+h-1-a] / det_{h-1-a}
  r[i] = -w[N-1-i]     / det_i            s[i] =  w[i]       / det_i
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.ops import windows as _windows


@dataclasses.dataclass(frozen=True)
class FoldCoefficients:
    """Precomputed per-sample fold/unfold weights (all shape [N/2], float64).

    Forward (analysis):
      wa_r = reversed w[:h]      — weight on flipped lower-half of previous block
      wb   = w[h:N]              — weight on upper-half of previous block
      wc   = w[N:3N/2]           — weight on lower-half of current block
      ffr  = reversed ff         — weight on flipped upper-half of current block

    Inverse (synthesis):
      p, q, r, s as derived in the module docstring (p applied flipped).
    """

    wa_r: np.ndarray
    wb: np.ndarray
    wc: np.ndarray
    ffr: np.ndarray
    p: np.ndarray
    q: np.ndarray
    r: np.ndarray
    s_r: np.ndarray


def make_fold_coefficients(filters_n: int, window_type) -> FoldCoefficients:
    """Build analysis + synthesis fold weights in float64 on the host."""
    w = _windows.window_coefficients(filters_n, window_type)
    ff = _windows.window_completion(w, filters_n)
    h = filters_n // 2
    i = np.arange(h)

    det = -w[i] * ff[h - 1 - i] - w[filters_n + i] * w[filters_n - 1 - i]
    a = np.arange(h)
    p = -ff[a] / det[h - 1 - a]
    q = -w[filters_n + h - 1 - a] / det[h - 1 - a]
    r = -w[filters_n - 1 - i] / det[i]
    s = w[i] / det[i]

    return FoldCoefficients(
        wa_r=w[:h][::-1].copy(),
        wb=w[h:filters_n].copy(),
        wc=w[filters_n : filters_n + h].copy(),
        ffr=ff[::-1].copy(),
        p=p,
        q=q,
        r=r,
        s_r=s[::-1].copy(),
    )


def fold(x_blocks: jnp.ndarray, wa_r, wb, wc, ffr) -> jnp.ndarray:
    """Analysis fold: [..., blocks, N] -> [..., blocks+1, N].

    Block n of the output mixes the previous input block (lower output half)
    with the current input block (upper output half); out-of-range input
    blocks are zero, which yields the reference's blocks+1 framing
    (audiocodec/mdctransformer.py:364-366).
    """
    h = x_blocks.shape[-1] // 2
    xl = x_blocks[..., :h]
    xu = x_blocks[..., h:]

    # Contribution of input block n to output block n+1 (lower half):
    #   lower[k] = w[h-1-k]*x[h-1-k] + w[h+k]*x[h+k]
    to_next = jnp.flip(xl, axis=-1) * wa_r + xu * wb
    # Contribution of input block n to output block n (upper half):
    #   upper[j] = w[N+j]*x[j] - ff[h-1-j]*x[N-1-j]
    to_cur = xl * wc - jnp.flip(xu, axis=-1) * ffr

    zeros = jnp.zeros_like(to_next[..., :1, :])
    lower = jnp.concatenate([zeros, to_next], axis=-2)
    upper = jnp.concatenate([to_cur, zeros], axis=-2)
    return jnp.concatenate([lower, upper], axis=-1)


def unfold(z_blocks: jnp.ndarray, p, q, r, s_r) -> jnp.ndarray:
    """Synthesis unfold: [..., blocks, N] -> [..., blocks+1, N].

    Inverse of :func:`fold` up to the one-block boundary padding: the first
    and last output blocks are only partially reconstructed (exactly the
    reference's behavior, tested by slicing them off —
    audiocodec/tests/test_mdctransformer.py:35).
    """
    h = z_blocks.shape[-1] // 2
    zl = z_blocks[..., :h]
    zu = z_blocks[..., h:]

    # out[n, k]   = p[h-1-k]*z[n, h-1-k] + r[k]*z[n-1, h+k]
    cur_low = jnp.flip(zl * p, axis=-1)
    prev_low = zu * r
    # out[n, h+j] = q[j]*z[n, j] + s[h-1-j]*z[n-1, N-1-j]
    cur_up = zl * q
    prev_up = jnp.flip(zu, axis=-1) * s_r

    zeros = jnp.zeros_like(zl[..., :1, :])
    low = jnp.concatenate([cur_low, zeros], axis=-2) + jnp.concatenate(
        [zeros, prev_low], axis=-2
    )
    up = jnp.concatenate([cur_up, zeros], axis=-2) + jnp.concatenate(
        [zeros, prev_up], axis=-2
    )
    return jnp.concatenate([low, up], axis=-1)


# ---------------------------------------------------------------------------
# Dense reference-structure matrices — used only by tests to cross-validate
# the sparse fold against an independent dense construction.
# ---------------------------------------------------------------------------


def filter_window_matrix(filters_n: int, window_type) -> np.ndarray:
    """Dense diamond folding matrix F, [N, N] float64 (test oracle).

    Structure mirrors reference audiocodec/mdctransformer.py:192-229:
    four diagonal/anti-diagonal blocks laced from the window coefficients.
    """
    w = _windows.window_coefficients(filters_n, window_type)
    ff = _windows.window_completion(w, filters_n)
    h = filters_n // 2
    F = np.zeros((filters_n, filters_n), dtype=np.float64)
    i = np.arange(h)
    F[i, h - 1 - i] = w[i]  # upper-left, anti-diagonal
    F[h + i, i] = w[h + i]  # lower-left, diagonal
    F[i, h + i] = w[filters_n + i]  # upper-right, diagonal
    F[h + i, filters_n - 1 - i] = -ff[i]  # lower-right, anti-diagonal
    return F


def dense_fold_matrices(filters_n: int, window_type):
    """(H0, H1) with y[n] = x[n] @ H0 + x[n-1] @ H1 — dense test oracle."""
    F = filter_window_matrix(filters_n, window_type)
    h = filters_n // 2
    H0 = F.copy()
    H0[:, :h] = 0.0  # current block feeds the upper output half
    H1 = F.copy()
    H1[:, h:] = 0.0  # previous block feeds the lower output half
    return H0, H1


def dense_unfold_matrices(filters_n: int, window_type):
    """(G0, G1) with out[n] = z[n] @ G0 + z[n-1] @ G1 — dense test oracle."""
    F = filter_window_matrix(filters_n, window_type)
    G = np.linalg.inv(F)
    h = filters_n // 2
    G0 = G.copy()
    G0[h:, :] = 0.0
    G1 = G.copy()
    G1[:h, :] = 0.0
    return G0, G1
