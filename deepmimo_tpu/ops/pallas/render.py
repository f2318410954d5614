"""Fused path->channel render for the GPU: per-path scalars in, H out.

One Pallas kernel (Triton route) computes, for each user and each block
of output rows, entirely in registers:

    E[q, p] = exp(j (m_t ky_t + n_t kz_t + m_r ky_r + n_r kz_r))  (panel pair)
    g[p, j] = amp[s, p] exp(j (psi[s, p] - omega[p] k)),  j = s * K + k
    H[q, j] = sum_p E[q, p] g[p, j]                     (four tensor-core dots)

and stores H to device memory exactly once. Its inputs are only the
per-path scalars ([U, P] each), so the kernel's memory traffic is about
the output tensor. The plain XLA renderer instead writes the array
responses, E, the gain planes and four matmul partials to device memory
and reads them back.

The panel layout follows ops/geometry.py: ant_indices lays an (M1, M2)
panel in the y-z plane with t = n * M1 + m, so phase[t] = m ky + n kz
(reference deepmimo/generator/geometry.py:105-120), and the pair index is
q = r * T + t. Subcarriers must form an arithmetic progression
k0 + stride * arange(K); the caller folds k0 into psi and the stride into
omega. The slot axis s carries Doppler snapshots or polarizations: psi is
[U, S*P], amp [U, P] (shared) or [U, S*P] (per slot).

Gradients: the custom VJP differentiates the plain XLA reference
(:func:`_reference_impl`); the kernel is the forward path only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


# ----------------------------------------------------------------------------
# Plain XLA reference (correctness oracle, gradient path, non-GPU renderer)
# ----------------------------------------------------------------------------

def panel_response(ky, kz, m1: int, m2: int):
    """Planar-panel response planes [U, m1*m2, P] from per-path phase steps.

    ``ky``/``kz`` are [U, P]; antenna t = n * m1 + m has phase m ky + n kz.
    """
    u, p = ky.shape
    m = jnp.arange(m1, dtype=ky.dtype)
    n = jnp.arange(m2, dtype=ky.dtype)
    ph = (m[None, :, None, None] * ky[:, None, None, :] +
          n[None, None, :, None] * kz[:, None, None, :])
    ph = ph.transpose(0, 2, 1, 3).reshape(u, m1 * m2, p)
    return jnp.cos(ph), jnp.sin(ph)


def gain_planes(amp, psi, omega, n_k: int):
    """OFDM gain planes [U, S, P, K]: amp e^{j(psi_s - omega k)}.

    ``psi`` is [U, S*P]; ``amp`` is [U, P] (shared by every slot) or
    [U, S*P] (one amplitude per slot).
    """
    u, p = omega.shape
    n_s = psi.shape[1] // p
    n_sa = amp.shape[1] // p
    ks = jnp.arange(n_k, dtype=amp.dtype)
    base = (psi.reshape(u, n_s, p)[..., None] -
            omega[:, None, :, None] * ks)
    amp_b = amp.reshape(u, n_sa, p)[..., None]
    return amp_b * jnp.cos(base), amp_b * jnp.sin(base)


def _reference_impl(gry, grz, gty, gtz, amp, psi, omega, rx_shape, tx_shape,
                    n_k, precision=lax.Precision.HIGHEST):
    """Same math as the kernel in plain XLA: (hr, hi), each [U, Q, S*K].

    HIGHEST is the oracle's precision (full float32 products on every
    backend); the product's non-GPU renderer passes its configured one.
    """
    u, p = omega.shape
    n_s = psi.shape[1] // p
    arx_r, arx_i = panel_response(gry, grz, *rx_shape)
    atx_r, atx_i = panel_response(gty, gtz, *tx_shape)
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :])
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :])
    q = er.shape[1] * er.shape[2]
    er, ei = er.reshape(u, q, p), ei.reshape(u, q, p)
    gr, gi = gain_planes(amp, psi, omega, n_k)

    def mm(a, b):
        return jnp.einsum("uqp,uspk->uqsk", a, b,
                          preferred_element_type=jnp.float32,
                          precision=precision).reshape(u, q, n_s * n_k)
    return mm(er, gr) - mm(ei, gi), mm(er, gi) + mm(ei, gr)


# ----------------------------------------------------------------------------
# Kernel
# ----------------------------------------------------------------------------

class Tiles(NamedTuple):
    """Launch shape of the kernel (hashable: part of the jit key). Each
    program renders one user (grid axis 0) and one block of rows."""

    rows: int         # output rows q per program (grid axis 1)
    cols: int         # output columns j per inner step (looped)
    num_warps: int


def _pow2(x: int, floor: int = 16) -> int:
    """Next power of two >= max(x, floor): Triton blocks and dot operands
    need power-of-two sides of at least 16."""
    return max(floor, 1 << (max(int(x), 1) - 1).bit_length())


def pick_tiles(n_q: int, n_sk: int) -> Tiles:
    """Launch shape for one render config: the one place block sizes live.

    From a sweep on an H100 (PERF.md): 64 output rows and 32 columns per
    step, 4 warps. The two [rows, cols] float32 accumulators, E [rows, P]
    and g [P, cols] then stay in registers at the path counts scenarios
    carry.
    """
    return Tiles(rows=min(_pow2(n_q), 64), cols=min(_pow2(n_sk), 32),
                 num_warps=4)


# matmul_dtype -> path-sum dot algorithm on the tensor cores. "float32"
# takes three TF32 passes (about float32 accuracy at tensor-core rate).
_DOT_ALGORITHM = {
    "float32": lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
    "highest": lax.DotAlgorithmPreset.F32_F32_F32,
    "bfloat16": lax.DotAlgorithmPreset.BF16_BF16_F32,
    "default": None,
}


def _dot_algorithm(mm_dtype: str, interpret: bool):
    if mm_dtype not in _DOT_ALGORITHM:
        raise ValueError(f"matmul_dtype={mm_dtype!r}: expected one of "
                         f"{sorted(_DOT_ALGORITHM)}")
    alg = _DOT_ALGORITHM[mm_dtype]
    if interpret and alg == lax.DotAlgorithmPreset.TF32_TF32_F32_X3:
        # The interpreter runs the dot on the CPU, which has no TF32.
        return lax.DotAlgorithmPreset.F32_F32_F32
    return alg


def _kernel(gry_ref, grz_ref, gty_ref, gtz_ref, amp_ref, psi_ref, omega_ref,
            h_ref, *, n_paths, rx_shape, tx_shape, n_k, n_s, slot_amp,
            packed, tiles, algorithm):
    f32 = jnp.float32
    (r1, r2), (t1, t2) = rx_shape, tx_shape
    n_t = t1 * t2
    n_q = r1 * r2 * n_t
    n_sk = n_s * n_k
    pp = _pow2(n_paths)

    p = jnp.arange(pp)
    p_ok = p < n_paths
    u = pl.program_id(0)
    q = pl.program_id(1) * tiles.rows + jnp.arange(tiles.rows)
    q_ok = q < n_q
    t = q % n_t
    m_t, n_t_ = (t % t1).astype(f32), (t // t1).astype(f32)
    r = q // n_t
    m_r, n_r = (r % r1).astype(f32), (r // r1).astype(f32)
    dot = functools.partial(pl.dot, precision=algorithm)

    def load(ref):
        return plgpu.load(ref.at[u, p], mask=p_ok, other=0.0)

    ph = (m_t[:, None] * load(gty_ref)[None, :] +
          n_t_[:, None] * load(gtz_ref)[None, :])
    if r1 * r2 > 1:
        ph += (m_r[:, None] * load(gry_ref)[None, :] +
               n_r[:, None] * load(grz_ref)[None, :])
    er, ei = jnp.cos(ph), jnp.sin(ph)                      # [rows, pp]
    omega = load(omega_ref)
    amp = None if slot_amp else load(amp_ref)

    def column_block(c, carry):
        j = c * tiles.cols + jnp.arange(tiles.cols)
        j_ok = j < n_sk
        k = (j % n_k).astype(f32)
        slot = p[:, None] + (j // n_k)[None, :] * n_paths
        pj_ok = p_ok[:, None] & j_ok[None, :]
        psi = plgpu.load(psi_ref.at[u, slot], mask=pj_ok, other=0.0)
        if slot_amp:
            a = plgpu.load(amp_ref.at[u, slot], mask=pj_ok, other=0.0)
        else:
            a = amp[:, None]
        base = psi - omega[:, None] * k[None, :]
        gr, gi = a * jnp.cos(base), a * jnp.sin(base)      # [pp, cols]
        hr = (dot(er, gr) - dot(ei, gi)).astype(h_ref.dtype)
        hi = (dot(er, gi) + dot(ei, gr)).astype(h_ref.dtype)
        ok = q_ok[:, None] & j_ok[None, :]
        qi, ji = q[:, None], j[None, :]
        if packed:
            plgpu.store(h_ref.at[u, qi, ji], hr, mask=ok)
            plgpu.store(h_ref.at[u, qi, ji + n_sk], hi, mask=ok)
        else:
            plgpu.store(h_ref.at[0, u, qi, ji], hr, mask=ok)
            plgpu.store(h_ref.at[1, u, qi, ji], hi, mask=ok)
        return carry

    lax.fori_loop(0, pl.cdiv(n_sk, tiles.cols), column_block, 0)


def _fwd_impl(gry, grz, gty, gtz, amp, psi, omega, rx_shape, tx_shape, n_k,
              interpret, mm_dtype, packed, out_dtype, tiles):
    if out_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"out_dtype={out_dtype!r}: expected 'float32' "
                         "or 'bfloat16'")
    u, p = omega.shape
    n_s = psi.shape[1] // p
    n_q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
    n_sk = n_s * n_k
    tiles = tiles or pick_tiles(n_q, n_sk)
    if rx_shape[0] * rx_shape[1] == 1:
        gry = grz = gty          # single RX antenna: never read, not shipped
    odt = jnp.dtype(out_dtype)
    out = (jax.ShapeDtypeStruct((u, n_q, 2 * n_sk), odt) if packed else
           jax.ShapeDtypeStruct((2, u, n_q, n_sk), odt))
    kern = functools.partial(
        _kernel, n_paths=p, rx_shape=rx_shape, tx_shape=tx_shape, n_k=n_k,
        n_s=n_s, slot_amp=amp.shape[1] != p, packed=packed, tiles=tiles,
        algorithm=_dot_algorithm(mm_dtype, interpret))
    f32 = lambda x: x.astype(jnp.float32)
    return pl.pallas_call(
        kern,
        out_shape=out,
        grid=(u, pl.cdiv(n_q, tiles.rows)),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=tiles.num_warps,
                                             num_stages=1),
        name="fused_render",
    )(*map(f32, (gry, grz, gty, gtz, amp, psi, omega)))


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8, 9, 10, 11, 12, 13,
                                                    14))
def fused_render(gry, grz, gty, gtz, amp, psi, omega,
                 rx_shape: Tuple[int, int], tx_shape: Tuple[int, int],
                 n_k: int, interpret: bool = False,
                 mm_dtype: str = "float32", packed: bool = False,
                 out_dtype: str = "float32",
                 tiles: Optional[Tiles] = None) -> jax.Array:
    """Fused channel render from per-path scalars -> H planes.

    Args:
        gry/grz: RX wave-vector phase steps kd sin(theta) sin(phi) and
            kd cos(theta) per path [U, P] (rotated-frame angles, zero on
            invalid paths).
        gty/gtz: TX equivalents [U, P].
        amp: per-path linear amplitude, 0 for invalid or over-FFT paths:
            [U, P], or [U, S*P] with one amplitude per slot (the
            dual-polarization layout; reference deepmimo_v3/generator/
            python/generator.py:71-78 renders the four polarizations as
            four independent passes).
        psi: per-path phase at the first selected subcarrier (radians,
            Doppler included) [U, S*P]; S slots render stacked along the
            output column axis.
        omega: phase slope per subcarrier step 2 pi delay_n stride / N.
        rx_shape/tx_shape: static panel shapes (M1, M2).
        n_k: number of subcarriers rendered per slot.
        interpret: run the kernel in the Pallas interpreter (CPU tests).
        mm_dtype: path-sum precision ('float32' = 3 TF32 passes,
            'highest' = full float32, 'bfloat16', 'default').
        tiles: launch shape; :func:`pick_tiles` when None.

    Returns:
        stacked (packed=False): [2, U, Q, S*K], real/imag planes stacked
        on the leading axis. packed (packed=True): [U, Q, 2*S*K] with hr
        in the first minor half and hi in the second. ``out_dtype
        ='bfloat16'`` stores H in bf16 (half the output bytes, ~2^-8
        relative rounding; the arithmetic stays float32).
    """
    return _fwd_impl(gry, grz, gty, gtz, amp, psi, omega, rx_shape, tx_shape,
                     n_k, interpret, mm_dtype, packed, out_dtype, tiles)


def _fwd(gry, grz, gty, gtz, amp, psi, omega, rx_shape, tx_shape, n_k,
         interpret, mm_dtype, packed, out_dtype, tiles):
    out = _fwd_impl(gry, grz, gty, gtz, amp, psi, omega, rx_shape, tx_shape,
                    n_k, interpret, mm_dtype, packed, out_dtype, tiles)
    return out, (gry, grz, gty, gtz, amp, psi, omega)


def _bwd(rx_shape, tx_shape, n_k, interpret, mm_dtype, packed, out_dtype,
         tiles, res, ct):
    """VJP of the plain XLA reference, recomputed from the saved scalars."""
    ct = ct.astype(jnp.float32)          # bf16-out cotangents: f32 chain
    if packed:
        sk = ct.shape[-1] // 2
        ct = jnp.stack((ct[..., :sk], ct[..., sk:]))
    _, vjp = jax.vjp(
        lambda *a: jnp.stack(_reference_impl(*a, rx_shape, tx_shape, n_k)),
        *res)
    return vjp(ct)


fused_render.defvjp(_fwd, _bwd)
