"""Fixed-point emulation of the reference encoder hardware, in NumPy.

The port's own copy of what the device encoder (`encoder_torch`) and its
oracle need from `aloha_tpu/encoder_hw.py` (docs/ENCODER.md derives the
pipeline; reference: src/encoder/):

  1. Q1.32 quantize, round half to even;
  2. the st1 half-spectrum store with conjugation: slot k -> t = ((3^k
     mod 2N) - 1)/2, address t (imag negated) if t < N/2, else N-1-t
     (addr_gen.sv:36-60, cnt.sv:71-113);
  3. four 2048-point inverse FFTs, radix-2^2, 34-bit data and phase
     factors at scale 2^33 (plus the fitted PHASE_FIX corrections), a
     convergent-rounded >> 35 per stage pair and >> 1 at the final radix-2
     stage; channel c reads bank c ascending, then bank 3-c descending,
     conjugated (pp_st1.sv:105-114);
  4. the 4x4 combine with the per-product cmpy truncation >> 28 (`rtl`),
     or one floor of the full-precision sum (`cmodel`, the reference's
     software model), against the tf_data ROMs (controller.sv:502-553);
  5. the sign fix per limb, x < 0 -> x + q; coefficient i = 2048 r + k
     (controller.sv:629-704).

`encoder_torch` builds its phase-factor tables, output permutation and
combine ROMs here on the host and runs the same arithmetic as int64 tensor
ops; `chip_smoke.py` holds the card's encodings against `encode` below.
The JAX package's sweep hooks (`TIE_LEVEL_OVERRIDE`, `raw_stats`) are not
carried over.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig

MASK34 = (1 << 34) - 1

#: Directory of the reference's shipped combine ROMs (tf_data{c}{r}.mem),
#: or None for the ideal closed-form table.  The JAX package loads the
#: shipped ROMs when the reference tree is mounted at its fixed location
#: and the ideal table otherwise; a caller that holds the reference tree
#: sets this to its src/encoder/tf_data so that both packages read the same
#: source (the tests do).
ROM_DIR: str | None = None

#: Tie-break at exact .5 fractions, per rounding site: "even" is the
#: convergent rounding of the shipped IP configuration.
TIE_SHIFT = "even"  # plain scale shifts (>> 2 per stage pair, >> 1 final)
TIE_PROD = "even"  # the twiddle-product shift (>> 35 per stage pair)


def _tie_adj(q, frac, half, mode: str):
    """The +1 applied at exact ties (frac == half) given the floor quotient q."""
    at = frac == half
    if mode == "even":
        return at & (q & 1)
    if mode == "odd":
        return at & (~q & 1)
    if mode == "up":
        return at.astype(np.int64)
    if mode == "down":
        return np.zeros_like(q)
    if mode == "away":
        return at & (q >= 0)
    if mode == "toward":
        return at & (q < 0)
    raise ValueError(f"unknown tie mode {mode!r}")


def _shift_round_conv(v: np.ndarray, s: int):
    """Convergent (half-to-even) rounding of v / 2^s on int64."""
    q = v >> s
    frac = v & ((1 << s) - 1)
    half = 1 << (s - 1)
    return q + (frac > half) + _tie_adj(q, frac, half, TIE_SHIFT).astype(np.int64)


def _cmul_shift_conv(vr, vi, wr, wi, s: int):
    """Convergent-rounded (v * w) >> s on complex int64 pairs, exact through
    16-bit twiddle splits (every product stays inside int64)."""
    def raw(v, w):
        return v * (w >> 16), v * (w & 0xFFFF)

    ar_hi, ar_lo = raw(vr, wr)
    bi_hi, bi_lo = raw(vi, wi)
    cr_hi, cr_lo = raw(vr, wi)
    di_hi, di_lo = raw(vi, wr)
    re_hi, re_lo = ar_hi - bi_hi, ar_lo - bi_lo
    im_hi, im_lo = cr_hi + di_hi, cr_lo + di_lo

    def fin(hi, lo):
        q1 = hi + (lo >> 16)
        rem = lo & 0xFFFF
        k = s - 16
        qf = q1 >> k
        frac = ((q1 & ((1 << k) - 1)) << 16) | rem
        half = 1 << (s - 1)
        return qf + (frac > half) + _tie_adj(qf, frac, half, TIE_PROD).astype(np.int64)

    return fin(re_hi, re_lo), fin(im_hi, im_lo)


def _trunc_prod_sum(Fr, Fi, Tr, Ti):
    """sum over the channel axis of trunc((F * T).re >> 28): the cmpy path."""
    acc = np.zeros(Fr.shape[1:], dtype=np.int64)
    for c in range(Fr.shape[0]):
        re_hi = Fr[c] * (Tr[c] >> 16) - Fi[c] * (Ti[c] >> 16)
        re_lo = Fr[c] * (Tr[c] & 0xFFFF) - Fi[c] * (Ti[c] & 0xFFFF)
        acc += (re_hi + (re_lo >> 16)) >> 12  # (q1 2^16 + rem) >> 28
    return acc


def _full_prod_sum_floor(Fr, Fi, Tr, Ti):
    """floor(sum_c (F * T).re / 2^28): the C-model combine."""
    acc_hi = np.zeros(Fr.shape[1:], dtype=np.int64)
    acc_lo = np.zeros(Fr.shape[1:], dtype=np.int64)
    for c in range(Fr.shape[0]):
        acc_hi += Fr[c] * (Tr[c] >> 16) - Fi[c] * (Ti[c] >> 16)
        acc_lo += Fr[c] * (Tr[c] & 0xFFFF) - Fi[c] * (Ti[c] & 0xFFFF)
    return (acc_hi + (acc_lo >> 16)) >> 12


# ------------------------------------------------------------------- tables
#: Per-entry corrections to the FFT core's stored phase factors, keyed by
#: (L, q, n) stage-pair coordinates, values (d_re, d_im) in 2^33-scale LSBs
#: (fitted against the reference's RTL encode dumps; equal to
#: `aloha_tpu.encoder_hw.PHASE_FIX`).
PHASE_FIX: dict = {
    (8, 1, 1): (2, -1), (8, 3, 1): (3, 2),
    (32, 1, 1): (-1, -4), (32, 1, 2): (-1, 1), (32, 1, 3): (-2, 0), (32, 1, 4): (1, -2),
    (32, 1, 5): (0, 2), (32, 1, 6): (0, 1), (32, 1, 7): (-2, -2),
    (32, 2, 1): (1, 2), (32, 2, 3): (-2, 2), (32, 2, 5): (2, 0), (32, 2, 6): (-1, 0),
    (32, 2, 7): (2, 0),
    (32, 3, 1): (2, -2), (32, 3, 2): (1, 1), (32, 3, 3): (1, -2), (32, 3, 4): (2, 1),
    (32, 3, 5): (-2, -1), (32, 3, 6): (3, -3),
    (128, 1, 1): (-1, 0), (128, 1, 3): (2, 0), (128, 1, 5): (1, 0), (128, 1, 9): (1, 0),
    (128, 1, 18): (1, 1), (128, 1, 21): (-1, 0), (128, 1, 28): (2, 0), (128, 1, 30): (-1, 0),
    (128, 1, 31): (-2, 0),
    (128, 2, 1): (-1, 0), (128, 2, 3): (-1, 0), (128, 2, 4): (-1, 0), (128, 2, 5): (-1, 0),
    (128, 2, 10): (1, -1), (128, 2, 13): (-1, 0), (128, 2, 28): (1, -1), (128, 2, 30): (0, 2),
    (128, 2, 31): (0, 1),
    (128, 3, 1): (-1, 0), (128, 3, 3): (-1, -1), (128, 3, 4): (-1, -1), (128, 3, 5): (-2, -1),
    (128, 3, 10): (1, 0), (128, 3, 11): (-1, 0), (128, 3, 14): (1, 0), (128, 3, 17): (0, -1),
    (128, 3, 20): (1, -1), (128, 3, 22): (0, -1), (128, 3, 27): (0, -1), (128, 3, 30): (-1, -1),
    (128, 3, 31): (-2, 1),
    (512, 1, 5): (1, 0), (512, 1, 28): (-2, 0), (512, 1, 85): (1, -1), (512, 1, 86): (1, 0),
    (512, 2, 1): (-1, 0), (512, 2, 13): (1, 0), (512, 2, 23): (1, 0), (512, 2, 36): (1, 0),
    (512, 2, 86): (1, 2), (512, 2, 99): (-1, 0), (512, 2, 127): (1, 0),
    (512, 3, 5): (0, 1), (512, 3, 10): (0, 1), (512, 3, 50): (-1, 0), (512, 3, 86): (1, 0),
    (512, 3, 114): (0, 1), (512, 3, 117): (-2, 0), (512, 3, 127): (0, 1),
    (2048, 2, 127): (-1, 0), (2048, 2, 203): (-1, -1), (2048, 3, 99): (1, 0),
}


@functools.lru_cache(maxsize=None)
def _tw_tables(L: int):
    """Quantized inverse phase factors W_L^{qn} = rne(2^33 e^{2 pi i qn/L})
    of the three non-trivial branches of a radix-2^2 stage pair, with the
    PHASE_FIX corrections: {q: (re, im)} int64 arrays of length L/4."""
    n = np.arange(L // 4)
    out = {}
    for q in (1, 2, 3):
        ang = 2 * np.pi * q * n / L
        re = np.rint(np.cos(ang) * 2.0**33).astype(np.int64)
        im = np.rint(np.sin(ang) * 2.0**33).astype(np.int64)
        for (fl, fq, fn), (dre, dim) in PHASE_FIX.items():
            if fl == L and fq == q:
                re[fn] += dre
                im[fn] += dim
        out[q] = (re, im)
    return out


@functools.lru_cache(maxsize=None)
def load_combine_roms(path: str) -> np.ndarray:
    """tf_data{c}{r}.mem under `path` -> (4, 4, 2048, 2) int64 (re, im),
    34-bit signed: 2^32 zeta^((2c+1)(2048 r + k)), zeta = e^{i pi/8192}
    (reference: src/encoder/tf_buf.sv)."""
    T = np.zeros((4, 4, 2048, 2), dtype=np.int64)
    for c in range(4):
        for r in range(4):
            with open(os.path.join(path, f"tf_data{c}{r}.mem")) as f:
                for k, line in enumerate(f):
                    v = int(line.strip(), 2)
                    re, im = (v >> 34) & MASK34, v & MASK34
                    T[c, r, k] = (re - (1 << 34) if re >> 33 else re,
                                  im - (1 << 34) if im >> 33 else im)
    return T


@functools.lru_cache(maxsize=None)
def combine_roms_np(n: int = 8192) -> np.ndarray:
    """The ideal combine ROMs T[c][r][k] = rne(2^32 zeta^((2c+1)(2048 r + k)))."""
    T = np.zeros((4, 4, 2048, 2), dtype=np.int64)
    k = np.arange(2048)
    for c in range(4):
        for r in range(4):
            ang = np.pi * (2 * c + 1) * (2048 * r + k) / n
            T[c, r, :, 0] = np.rint(np.cos(ang) * 2.0**32)
            T[c, r, :, 1] = np.rint(np.sin(ang) * 2.0**32)
    return T


def get_combine_roms(n: int = 8192) -> np.ndarray:
    """The shipped ROMs from ROM_DIR when it is set, else the ideal table."""
    if ROM_DIR is not None:
        return load_combine_roms(ROM_DIR)
    return combine_roms_np(n)


# ----------------------------------------------------------------- the FFT
@functools.lru_cache(maxsize=None)
def _dit_perm(L: int) -> np.ndarray:
    """Output gather of the iterative radix-2^2 DIT: after d twiddle levels
    the value at flat index f = 2 blk + e (blk's base-4 digits big-endian)
    belongs at p = sum_i q_i 4^(i-1) + e 4^d.  Returns src[p] = f."""
    d, Lc = 0, L
    while Lc > 2:
        Lc //= 4
        d += 1
    if Lc != 2:
        raise ValueError(f"L={L} must be 2 * 4^k")
    f = np.arange(L)
    e, blk = f & 1, f >> 1
    p = e << (2 * d)
    for i in range(d):  # q_d is blk's least significant base-4 digit
        p += ((blk >> (2 * i)) & 3) << (2 * (d - 1 - i))
    src = np.empty(L, dtype=np.int64)
    src[p] = f
    return src


def xfft2048(xr: np.ndarray, xi: np.ndarray):
    """The 2048-point scaled radix-2^2 inverse FFT (34-bit, net 1/2048,
    convergent rounding) over the last axis of (..., L) int64: natural-order
    outputs."""
    L = xr.shape[-1]
    lead = xr.shape[:-1]
    vr = xr.reshape(lead + (1, L))
    vi = xi.reshape(lead + (1, L))
    Lc = L
    while Lc > 2:
        Lq = Lc // 4
        a_r, b_r, c_r, d_r = (vr[..., i * Lq:(i + 1) * Lq] for i in range(4))
        a_i, b_i, c_i, d_i = (vi[..., i * Lq:(i + 1) * Lq] for i in range(4))
        t0r, t0i = a_r + c_r, a_i + c_i
        t1r, t1i = b_r + d_r, b_i + d_i
        u0r, u0i = a_r - c_r, a_i - c_i
        u1r, u1i = b_r - d_r, b_i - d_i
        raw = [  # inverse decimation branches k = 0, 1, 2, 3 (mod 4)
            (t0r + t1r, t0i + t1i),
            (u0r - u1i, u0i + u1r),
            (t0r - t1r, t0i - t1i),
            (u0r + u1i, u0i - u1r),
        ]
        tws = _tw_tables(Lc)
        sub = [(_shift_round_conv(raw[0][0], 2), _shift_round_conv(raw[0][1], 2))]
        sub += [_cmul_shift_conv(*raw[q], *tws[q], 35) for q in (1, 2, 3)]
        # the branch digit goes below the block axis: new_blk = 4 blk + q
        vr = np.stack([s[0] for s in sub], axis=-2).reshape(lead + (-1, Lq))
        vi = np.stack([s[1] for s in sub], axis=-2).reshape(lead + (-1, Lq))
        Lc = Lq
    er = np.stack([_shift_round_conv(vr[..., 0] + vr[..., 1], 1),
                   _shift_round_conv(vr[..., 0] - vr[..., 1], 1)], -1)
    ei = np.stack([_shift_round_conv(vi[..., 0] + vi[..., 1], 1),
                   _shift_round_conv(vi[..., 0] - vi[..., 1], 1)], -1)
    src = _dit_perm(L)
    shp = lead + (L,)
    return er.reshape(shp)[..., src], ei.reshape(shp)[..., src]


# ------------------------------------------------------------ the pipeline
def quantize_slots(cleartext: np.ndarray):
    """Interleaved re/im fp64 -> Q1.32 integers (round half to even)."""
    c = np.asarray(cleartext, dtype=np.float64).ravel()
    return (np.rint(c[0::2] * 2.0**32).astype(np.int64),
            np.rint(c[1::2] * 2.0**32).astype(np.int64))


def build_st1(z_re: np.ndarray, z_im: np.ndarray, n: int = 8192):
    """Half-spectrum store with the hardware's 3^k walk and conjugation."""
    S, M = n // 2, 2 * n
    st1r = np.zeros(S, dtype=np.int64)
    st1i = np.zeros(S, dtype=np.int64)
    v3 = 1
    for k in range(S):
        t = (v3 - 1) // 2
        if t < S:
            st1r[t], st1i[t] = z_re[k], -z_im[k]
        else:
            st1r[n - 1 - t], st1i[n - 1 - t] = z_re[k], z_im[k]
        v3 = v3 * 3 % M
    return st1r, st1i


def channel_ffts(st1r: np.ndarray, st1i: np.ndarray):
    """(4, 2048) FFT outputs: bank c ascending + conj(bank 3-c) descending."""
    j = np.arange(1024)
    jr = np.arange(1023, -1, -1)
    xr = np.zeros((4, 2048), dtype=np.int64)
    xi = np.zeros((4, 2048), dtype=np.int64)
    for c in range(4):
        xr[c, :1024] = st1r[4 * j + c]
        xi[c, :1024] = st1i[4 * j + c]
        xr[c, 1024:] = st1r[4 * jr + (3 - c)]
        xi[c, 1024:] = -st1i[4 * jr + (3 - c)]
    return xfft2048(xr, xi)


def encode(cleartext: np.ndarray, cfg: HEConfig = DEFAULT_CONFIG,
           combine: str = "rtl") -> np.ndarray:
    """Cleartext image (N interleaved re/im floats) -> (n_limbs, N) uint64
    coefficient-domain plaintext.  combine="rtl": the per-product cmpy
    truncation (the silicon); "cmodel": the full-precision sum and one
    floor (the reference's software model)."""
    if cfg.n != 8192:
        raise NotImplementedError(
            "the encoder hardware pipeline is fixed at N = 8192 "
            "(4 channels x 2048-point FFTs, reference: src/encoder/)"
        )
    if combine not in ("rtl", "cmodel"):
        raise ValueError(combine)
    Fr, Fi = channel_ffts(*build_st1(*quantize_slots(cleartext), cfg.n))
    T = get_combine_roms(cfg.n)
    fold = _trunc_prod_sum if combine == "rtl" else _full_prod_sum_floor
    m = np.concatenate([fold(Fr, Fi, T[:, r, :, 0], T[:, r, :, 1]) for r in range(4)])
    out = np.empty((cfg.n_limbs, cfg.n), dtype=np.uint64)
    for limb in range(cfg.n_limbs):
        out[limb] = np.where(m < 0, m + cfg.moduli[limb], m).astype(np.uint64)
    return out
