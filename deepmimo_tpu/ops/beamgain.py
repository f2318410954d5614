"""Codebook beam-gain maps from per-path scalars, without forming H.

Serving loops that only need codebook beam gains (beam training, initial
access, coverage maps) reduce H [U, R, T, K] to power maps [U, R, B, K];
the reference computes these host-side from the full H (its
beam-selection examples). Folding the codebook into the TX response
before the path sum,

    eb[b, p]      = sum_t conj(w[b, t]) a_tx[t, p]
    y[u, r, b, k] = sum_t conj(w[b, t]) H[u, r, t, k]
                  = sum_p a_rx[r, p] eb[b, p] g[p, k]
    G[u, r, b, k] = |y|^2

means H at T antennas is never formed: every per-antenna stage runs at
B beams instead. Plain jnp, so XLA fuses it and autodiff differentiates
it (codebook learning drives the same function that serves).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .pallas.render import _reference_impl, gain_planes, panel_response


def beam_gain(gry, grz, gty, gtz, amp, psi, omega, wr, wi, rx_shape,
              tx_shape, n_k: int, precision=lax.Precision.HIGHEST):
    """G[U, R*B, S*K] with the codebook folded into the path sum.

    Scalar inputs follow :func:`ops.pallas.render.fused_render` (zeroed
    invalid paths, psi [U, S*P] for S slots); ``wr/wi`` are the codebook
    planes [B, T]. The combiner applies conj(w), matching
    ``abs(h @ codebook.conj().T)**2`` consumer code.
    """
    u, p = omega.shape
    n_s = psi.shape[1] // p
    atx_r, atx_i = panel_response(gty, gtz, *tx_shape)        # [U, T, P]

    def fold(w, a):
        return jnp.einsum("bt,utp->ubp", w, a, precision=precision)

    # conj(w) a = wr ar + wi ai + j (wr ai - wi ar)
    ebr = fold(wr, atx_r) + fold(wi, atx_i)                  # [U, B, P]
    ebi = fold(wr, atx_i) - fold(wi, atx_r)
    arx_r, arx_i = panel_response(gry, grz, *rx_shape)        # [U, R, P]
    er = (arx_r[:, :, None, :] * ebr[:, None] -
          arx_i[:, :, None, :] * ebi[:, None]).reshape(u, -1, p)
    ei = (arx_r[:, :, None, :] * ebi[:, None] +
          arx_i[:, :, None, :] * ebr[:, None]).reshape(u, -1, p)
    gr, gi = gain_planes(amp, psi, omega, n_k)                # [U, S, P, K]

    def mm(a, b):
        return jnp.einsum("uqp,uspk->uqsk", a, b, precision=precision
                          ).reshape(u, a.shape[1], n_s * n_k)
    yr = mm(er, gr) - mm(ei, gi)
    yi = mm(er, gi) + mm(ei, gr)
    return yr * yr + yi * yi


def beam_gain_reference(gry, grz, gty, gtz, amp, psi, omega, wr, wi,
                        rx_shape, tx_shape, n_k: int):
    """Test oracle: G[u, r*B, S*K] through the explicit H.

    ``wr/wi`` are the codebook planes [B, T]; the beam combiner applies
    conj(w), matching `abs(h @ codebook.T.conj())**2` consumer code.
    """
    hr, hi = _reference_impl(gry, grz, gty, gtz, amp, psi, omega,
                             rx_shape, tx_shape, n_k)
    u, q, sk = hr.shape
    r = rx_shape[0] * rx_shape[1]
    t = tx_shape[0] * tx_shape[1]
    hr = hr.reshape(u, r, t, sk)
    hi = hi.reshape(u, r, t, sk)
    hp = lax.Precision.HIGHEST
    # conj(w) . h: re = wr.hr + wi.hi, im = wr.hi - wi.hr
    yr = jnp.einsum("bt,urtk->urbk", wr, hr, precision=hp) + \
        jnp.einsum("bt,urtk->urbk", wi, hi, precision=hp)
    yi = jnp.einsum("bt,urtk->urbk", wr, hi, precision=hp) - \
        jnp.einsum("bt,urtk->urbk", wi, hr, precision=hp)
    b = wr.shape[0]
    return (yr * yr + yi * yi).reshape(u, r * b, sk)
