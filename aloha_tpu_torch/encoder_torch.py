"""The fixed-point encoder as batched int64 tensor ops (the port of `encoder_jax`).

`encoder_hw`'s pipeline (reference: src/encoder/controller.sv:225-645),
computed on the cleartext's device, one batch of cleartexts at a time:

* the st1 half-spectrum store (3^k walk and conjugation) and the per-channel
  bank reads compose into one static gather and sign per channel, built
  once per ring size on the host (`_channel_gather_np`,
  aloha_tpu/encoder_jax.py:47-83);
* the four 2048-point 34-bit inverse FFTs run as one radix-2^2 level loop
  over (..., 4, 2048) with convergent rounding (`_xfft`, encoder_jax.py:
  148-190); products split the 34-bit phase factors at 16 bits, so that
  every product stays inside int64 (a whole 34 x 34-bit product would wrap
  silently, on the card as on the CPU);
* the cmpy-truncated combine and the sign fix are elementwise
  (encoder_jax.py:193-199, :237-241).

This was XLA code around no Pallas kernel in the JAX package, so plain
PyTorch on the card is its counterpart.  The phase factors and the combine
ROMs are built with NumPy on the host (`encoder_hw`), never recomputed on
the device: one ULP of a cosine flips a rounding.  `torch.round` rounds
half to even like `np.rint`, and `>>` on int64 tensors is arithmetic, as
the Q1.32 quantizer and the convergent rounding need.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aloha_tpu_torch import encoder_hw as H
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig


@functools.lru_cache(maxsize=None)
def _channel_gather_np(n: int):
    """The st1 store (slot k -> address, conjugation) composed with the
    channel bank reads: x_c[j] = (z_re[src[c, j]], sgn[c, j] z_im[src[c, j]]).
    src: (4, n/4) slot indices; sgn: (4, n/4) in {-1, +1}
    (reference: addr_gen.sv:36-60, cnt.sv:71-113, pp_st1.sv:45-114)."""
    S, M = n // 2, 2 * n
    st_src = np.zeros(S, dtype=np.int64)
    st_sgn = np.zeros(S, dtype=np.int64)
    v3 = 1
    for k in range(S):
        t = (v3 - 1) // 2
        if t < S:
            st_src[t], st_sgn[t] = k, -1
        else:
            st_src[n - 1 - t], st_sgn[n - 1 - t] = k, +1
        v3 = v3 * 3 % M
    Lc = S // 4  # channel c: bank c ascending, then bank 3-c descending, conjugated
    j = np.arange(Lc)
    jr = np.arange(Lc - 1, -1, -1)
    src = np.zeros((4, 2 * Lc), dtype=np.int64)
    sgn = np.zeros((4, 2 * Lc), dtype=np.int64)
    for c in range(4):
        src[c, :Lc] = st_src[4 * j + c]
        sgn[c, :Lc] = st_sgn[4 * j + c]
        src[c, Lc:] = st_src[4 * jr + (3 - c)]
        sgn[c, Lc:] = -st_sgn[4 * jr + (3 - c)]
    return src, sgn


@functools.lru_cache(maxsize=16)
def _consts(n: int, device: torch.device, rom_dir: str | None):
    """Per-(ring, device, ROM source) tensors: the channel gather and sign,
    the phase factors of each FFT level, the output permutation and the
    combine ROMs."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    src, sgn = _channel_gather_np(n)
    L = n // 4
    levels, Lc = [], L
    while Lc > 2:
        tws = H._tw_tables(Lc)
        levels.append({q: (t(tws[q][0]), t(tws[q][1])) for q in (1, 2, 3)})
        Lc //= 4
    roms = H.get_combine_roms(n)  # (4 channels, 4 rows, 2048, re/im)
    return t(src), t(sgn), levels, t(H._dit_perm(L)), t(roms[..., 0]), t(roms[..., 1])


def _shr_conv(v, s: int):
    """Convergent (half-to-even) rounding of v / 2^s."""
    q = v >> s
    frac = v & ((1 << s) - 1)
    half = 1 << (s - 1)
    return q + (frac > half).long() + ((frac == half) & ((q & 1) == 1)).long()


def _cmul_shr_conv(vr, vi, wr, wi, s: int):
    """Convergent-rounded (v w) >> s on complex int64 pairs, with the
    twiddle split at 16 bits (encoder_jax._cmul_shr_conv)."""
    def raw(v, w):
        return v * (w >> 16), v * (w & 0xFFFF)

    ar_hi, ar_lo = raw(vr, wr)
    bi_hi, bi_lo = raw(vi, wi)
    cr_hi, cr_lo = raw(vr, wi)
    di_hi, di_lo = raw(vi, wr)

    def fin(hi, lo):
        q1 = hi + (lo >> 16)
        k = s - 16
        qf = q1 >> k
        frac = ((q1 & ((1 << k) - 1)) << 16) | (lo & 0xFFFF)
        half = 1 << (s - 1)
        return qf + (frac > half).long() + ((frac == half) & ((qf & 1) == 1)).long()

    return fin(ar_hi - bi_hi, ar_lo - bi_lo), fin(cr_hi + di_hi, cr_lo + di_lo)


def _xfft(xr, xi, levels, perm):
    """The 34-bit scaled radix-2^2 inverse FFT over the last axis: (..., L)
    int64 in, natural order out (encoder_hw.xfft2048's arithmetic)."""
    L = xr.shape[-1]
    lead = xr.shape[:-1]
    vr = xr.reshape(lead + (1, L))
    vi = xi.reshape(lead + (1, L))
    for tws in levels:
        Lq = vr.shape[-1] // 4
        a_r, b_r, c_r, d_r = (vr[..., i * Lq:(i + 1) * Lq] for i in range(4))
        a_i, b_i, c_i, d_i = (vi[..., i * Lq:(i + 1) * Lq] for i in range(4))
        t0r, t0i = a_r + c_r, a_i + c_i
        t1r, t1i = b_r + d_r, b_i + d_i
        u0r, u0i = a_r - c_r, a_i - c_i
        u1r, u1i = b_r - d_r, b_i - d_i
        raw = [
            (t0r + t1r, t0i + t1i),
            (u0r - u1i, u0i + u1r),
            (t0r - t1r, t0i - t1i),
            (u0r + u1i, u0i - u1r),
        ]
        sub = [(_shr_conv(raw[0][0], 2), _shr_conv(raw[0][1], 2))]
        sub += [_cmul_shr_conv(*raw[q], *tws[q], 35) for q in (1, 2, 3)]
        vr = torch.stack([s[0] for s in sub], dim=-2).reshape(lead + (-1, Lq))
        vi = torch.stack([s[1] for s in sub], dim=-2).reshape(lead + (-1, Lq))
    er = torch.stack([_shr_conv(vr[..., 0] + vr[..., 1], 1),
                      _shr_conv(vr[..., 0] - vr[..., 1], 1)], -1).reshape(lead + (L,))
    ei = torch.stack([_shr_conv(vi[..., 0] + vi[..., 1], 1),
                      _shr_conv(vi[..., 0] - vi[..., 1], 1)], -1).reshape(lead + (L,))
    return er[..., perm], ei[..., perm]


def _combine_trunc(Fr, Fi, Tr, Ti):
    """sum_c trunc((F T).re >> 28) over the channel axis (-2): the cmpy
    truncation, with the ROM split at 16 bits."""
    re_hi = Fr * (Tr >> 16) - Fi * (Ti >> 16)
    re_lo = Fr * (Tr & 0xFFFF) - Fi * (Ti & 0xFFFF)
    return ((re_hi + (re_lo >> 16)) >> 12).sum(dim=-2)


def encode(cleartext, cfg: HEConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(..., N) float64 interleaved re/im cleartexts -> (..., n_limbs, N)
    int64 coefficient-domain residues, computed on the cleartext's device;
    word-equal to encoder_hw.encode(combine="rtl") for each cleartext."""
    if cfg.n != 8192:
        raise NotImplementedError(
            "the encoder hardware pipeline is fixed at N = 8192 "
            "(4 channels x 2048-point FFTs, reference: src/encoder/)"
        )
    c = torch.as_tensor(cleartext, dtype=torch.float64)
    if c.shape[-1] != cfg.n:
        raise ValueError(f"cleartext of {c.shape[-1]} values, expected {cfg.n}")
    src, sgn, levels, perm, Tr, Ti = _consts(cfg.n, c.device, H.ROM_DIR)
    z_re = torch.round(c[..., 0::2] * 2.0**32).to(torch.int64)
    z_im = torch.round(c[..., 1::2] * 2.0**32).to(torch.int64)
    Fr, Fi = _xfft(z_re[..., src], z_im[..., src] * sgn, levels, perm)  # (..., 4, 2048)
    m = torch.cat([_combine_trunc(Fr, Fi, Tr[:, r], Ti[:, r]) for r in range(4)], dim=-1)
    return torch.stack([torch.where(m < 0, m + q, m) for q in cfg.moduli[:cfg.n_limbs]],
                       dim=-2)
