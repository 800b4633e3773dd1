"""Key generation, encryption and decryption on int64 tensors.

The port of `aloha_tpu/keys.py`.  Each function is a drawing step
(`draw_*`: from the OS by default, as the JAX package's `SecureRng`, or from
a `torch.Generator` for reproducible runs) and a deterministic core that
turns the draws into keys or ciphertexts through `rns_torch` and the NTT
wrapper `ops.ntt_stream` (so on the card key generation and encryption
launch the NTT kernel).  The cores are held word for word against the JAX
package's functions on the same draws (tests/test_torch_host.py), and the
OS draws against its `rng=None` path on one byte stream
(tests/test_torch_keys_entropy.py).

Key-switch keys come in the accelerator's memory layout, (2L(L+1), N)
ordered [m0d0a, m0d0b, m0d1a, m0d1b, ..., m1d0a, ...]: per modulus the L
digits' (a, b) pairs, stride 2L (reference: sim/top/top_noaxilite_tb.sv:
372-393), with ka_j + kb_j s_tgt == P e_j s_src + err under every modulus.
A ciphertext is (a, b), decrypting as a + b s.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.ops import ntt_stream

SIGMA = 3.2  # standard deviation of the error polynomials


@dataclasses.dataclass
class SecretKey:
    coeff: torch.Tensor  # (N,) int64 in {-1, 0, 1}
    ntt: torch.Tensor  # (n_moduli, N) int64, NTT-domain residues


def _residues(signed, moduli):
    """Signed int64 (..., N) -> residues (..., M, N) under each modulus."""
    return torch.stack([torch.remainder(signed, q) for q in moduli], dim=-2)


def _ntt(res, cfg: HEConfig):
    """Forward NTT of residues (..., M, N) under the first M moduli."""
    M = res.shape[-2]
    return ntt_stream.transform_limbs(res, cfg.moduli[:M], cfg.psi[:M], False)


def _const(x, value: int):
    return torch.tensor(value, dtype=torch.int64, device=x.device)


#: random bits drawn beyond a span's bit length before a uniform draw is
#: reduced mod the span: its modular bias is below 2^-SLACK_BITS
SLACK_BITS = 128


def _slack_words(span: int, word_bits: int) -> int:
    """Words of word_bits random bits that cover bit_length(span) + SLACK_BITS."""
    return -(-(span.bit_length() + SLACK_BITS) // word_bits)


def uniform_chunks(cfg: HEConfig) -> int:
    """63-bit chunks per coefficient of a uniform integer mod prod(moduli),
    with 128 bits of slack (modular bias < 2^-128)."""
    return _slack_words(math.prod(cfg.moduli), 63)


# ------------------------------------------------------------------- draws
#
# Every draw reads its randomness from one of two sources.  generator=None
# means the OS (`os.urandom`, read as a module attribute): the bytes are
# consumed exactly as the JAX package's `keys.SecureRng` consumes them
# (aloha_tpu/keys.py:37-85), so one byte stream gives both packages the same
# words.  A `torch.Generator` gives reproducible draws on its device.  Either
# way a uniform integer mod a span is reduced from at least
# bit_length(span) + 128 random bits, so its modular bias is below 2^-128.
# OS draws are made on the host; the gen_* functions move them to the key's
# device.


def _mulmod_const(x, w: int, q: int):
    """x * w mod q for int64 x in [0, q) and Python ints w < q < 2^63:
    Shoup's product with the quotient floor(w 2^64 / q), whose remainder
    lies in [0, 2q) and so fits 64 unsigned bits; one unsigned subtract."""
    t = rt.mul_hi64(x, (w << 64) // q)
    r = rt.mul_lo64(x, w) - rt.mul_lo64(t, q)
    return torch.where(rt.uge(r, q), r - q, r)


def reduce_words(words, word_bits: int, span: int):
    """The integers sum_k words[k] 2^(word_bits k) mod span, exactly.

    words: a sequence of int64 tensors of one shape, low word first, each
    entry in [0, 2^word_bits) with word_bits <= 63; span in [1, 2^63].
    A power of two keeps the low bits; any other span is a Horner sum with
    unsigned compares, so a sum of two residues at or over 2^63 (negative as
    int64) still reduces right."""
    if not 1 <= span <= 1 << 63:
        raise ValueError(f"span {span} outside [1, 2^63]")
    words = list(words)
    if span & (span - 1) == 0:
        low = 0
        for k, w in enumerate(words):
            if word_bits * k >= 63:
                break
            low = low + (w << (word_bits * k))
        return low & (span - 1)
    radix = (1 << word_bits) % span
    r = torch.remainder(words[-1], span)
    for w in reversed(words[:-1]):
        r = _mulmod_const(r, radix, span) + torch.remainder(w, span)
        r = torch.where(rt.uge(r, span), r - span, r)
    return r


def uniform_below(span: int, shape, generator: torch.Generator) -> torch.Tensor:
    """Seeded integers (shape) int64 uniform in [0, span), span <= 2^63, on
    the generator's device: ceil((bit_length(span) + 128) / 63) words of
    `random_` (uniform in [0, 2^63)) reduced by `reduce_words`."""
    words = torch.empty((_slack_words(span, 63),) + tuple(shape), dtype=torch.int64,
                        device=generator.device).random_(generator=generator)
    return reduce_words(words, 63, span)


def _os_bytes(count: int, nbytes: int):
    """(count, nbytes) uint8 from the OS, row after row."""
    return np.frombuffer(os.urandom(count * nbytes), dtype=np.uint8).reshape(count, nbytes)


def os_int_bytes(span: int) -> int:
    """Bytes of one `SecureRng.integers` element: ceil((bit_length + 128) / 8)."""
    return _slack_words(span, 8)


def os_integers_from(raw, span: int) -> torch.Tensor:
    """raw (..., os_int_bytes(span)) uint8, each row a little-endian integer
    -> (...) int64 CPU tensor of the integers mod span (`SecureRng.integers`
    with low = 0), reduced as 32-bit words."""
    raw = np.asarray(raw, dtype=np.uint8)
    pad = -raw.shape[-1] % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(raw.shape[:-1] + (pad,), np.uint8)], axis=-1)
    words = torch.from_numpy(np.ascontiguousarray(raw).view("<u4").astype(np.int64))
    return reduce_words(words.unbind(-1), 32, span)


def os_normal_from(raw, sigma: float) -> np.ndarray:
    """raw (count, 16 m) uint8, each row the bytes of one `SecureRng.normal`
    call of m (even) values -> (count, m) float64, Box-Muller as it computes
    it: u = (word >> 11) / 2^53 over '<u8' words, u1 the first m clipped at
    1e-300, the cos half then the sin half, scaled by sigma."""
    raw = np.ascontiguousarray(np.asarray(raw, dtype=np.uint8))
    m = raw.shape[-1] // 16
    u = (raw.view("<u8") >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    u1, u2 = np.clip(u[:, :m], 1e-300, 1.0), u[:, m:]
    r = np.sqrt(-2.0 * np.log(u1))
    z = np.concatenate([r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)], axis=-1)
    return 0.0 + sigma * z


def _os_noise_from(raw, n: int) -> torch.Tensor:
    """Rounded Gaussian polynomials (count, n) from `normal` calls' bytes."""
    return torch.from_numpy(np.rint(os_normal_from(raw, SIGMA)[:, :n]).astype(np.int64))


def _normal_bytes(n: int) -> int:
    return 16 * ((n + 1) // 2 * 2)


def draw_secret(cfg: HEConfig, generator: torch.Generator = None) -> torch.Tensor:
    """Ternary secret coefficients (N,) int64 in {-1, 0, 1}, uniform."""
    if generator is None:
        return os_integers_from(_os_bytes(cfg.n, os_int_bytes(3)), 3) - 1
    return uniform_below(3, (cfg.n,), generator) - 1


def draw_noise(cfg: HEConfig, generator: torch.Generator = None, lead=()) -> torch.Tensor:
    """Rounded Gaussian error polynomials (*lead, N) int64, sigma = SIGMA;
    from the OS one `normal` call a polynomial, in row-major order."""
    shape = tuple(lead) + (cfg.n,)
    if generator is None:
        count = math.prod(lead)
        return _os_noise_from(_os_bytes(count, _normal_bytes(cfg.n)), cfg.n).reshape(shape)
    g = torch.normal(0.0, SIGMA, shape, generator=generator,
                     dtype=torch.float64, device=generator.device)
    return torch.round(g).to(torch.int64)  # half to even, as np.rint


def draw_uniform(cfg: HEConfig, generator: torch.Generator = None, lead=()) -> torch.Tensor:
    """(*lead, chunks, N) int64 words in [0, 2^63): the chunks of uniform
    integer polynomials mod prod(moduli), low chunk first (from the OS, as
    `SecureRng.integers(0, 2^63)` a chunk: the low 63 bits of 24 bytes)."""
    shape = tuple(lead) + (uniform_chunks(cfg), cfg.n)
    if generator is None:
        span = 1 << 63
        raw = _os_bytes(math.prod(shape), os_int_bytes(span))
        return os_integers_from(raw, span).reshape(shape)
    return torch.empty(shape, dtype=torch.int64,
                       device=generator.device).random_(generator=generator)


def draw_ksk(cfg: HEConfig, generator: torch.Generator = None):
    """The draws of one key-switch key, digit by digit: (chunks (L, c, N),
    noise (L, N)); per digit the chunks, then the error."""
    per = [(draw_uniform(cfg, generator), draw_noise(cfg, generator))
           for _ in range(cfg.n_limbs)]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])


def draw_encryption(cfg: HEConfig, generator: torch.Generator = None, lead=()):
    """The draws of encryptions of shape lead: (noise (*lead, N), b
    (*lead, L, N) uniform residues, the NTT-domain b-parts).

    From the OS the encryptions are drawn one after another in row-major
    order, each as the JAX package's `encrypt` draws it (its noise, then b
    limb by limb), so a batch equals that many sequential single calls."""
    L, n, lead = cfg.n_limbs, cfg.n, tuple(lead)
    moduli = cfg.moduli[:L]
    if generator is None:
        sizes = [_normal_bytes(n)] + [n * os_int_bytes(q) for q in moduli]
        raw = _os_bytes(math.prod(lead), sum(sizes))
        cuts = np.cumsum(sizes)[:-1]
        parts = np.split(raw, cuts, axis=1)
        e = _os_noise_from(parts[0], n)
        b = torch.stack([os_integers_from(p.reshape(-1, n, os_int_bytes(q)), q)
                         for p, q in zip(parts[1:], moduli)], dim=-2)
        return e.reshape(lead + (n,)), b.reshape(lead + (L, n))
    e = draw_noise(cfg, generator, lead)
    b = torch.stack([uniform_below(q, lead + (n,), generator) for q in moduli], dim=-2)
    return e, b


# ------------------------------------------------------------------- cores
def secret_key(coeff, cfg: HEConfig = DEFAULT_CONFIG) -> SecretKey:
    """The secret key of ternary coefficients (N,): its NTT under every
    modulus (P included)."""
    return SecretKey(coeff=coeff, ntt=_ntt(_residues(coeff, cfg.moduli), cfg))


def uniform_ntt(chunks, cfg: HEConfig = DEFAULT_CONFIG):
    """chunks (..., c, N) -> the NTT-domain residues (..., M, N) of the
    integers sum_k chunks[k] 2^(63k) mod prod(moduli).  Each modulus divides
    the product, so its residue is a Horner sum mod q."""
    res = []
    for q in cfg.moduli:
        radix = _const(chunks, (1 << 63) % q)
        r = torch.remainder(chunks[..., -1, :], q)
        for k in range(chunks.shape[-2] - 2, -1, -1):
            r = rt.addmod(rt.mulmod(r, radix, q), torch.remainder(chunks[..., k, :], q), q)
        res.append(r)
    return _ntt(torch.stack(res, dim=-2), cfg)


def ksk_from_draws(s_src_coeff, s_tgt: SecretKey, chunks, noise,
                   cfg: HEConfig = DEFAULT_CONFIG):
    """Key-switch key s_src -> s_tgt, (2L(L+1), N) int64 in the accelerator's
    layout, from the draws of `draw_ksk`: kb_j uniform, ka_j = P e_j s_src +
    err_j - kb_j s_tgt (P e_j is P mod q_j under the digit's own modulus
    and 0 under every other)."""
    L = cfg.n_limbs
    src = _ntt(_residues(s_src_coeff, cfg.moduli), cfg)
    kb = uniform_ntt(chunks, cfg)  # (L, M, N)
    err = _ntt(_residues(noise, cfg.moduli), cfg)  # (L, M, N)
    rows = [None] * (2 * L * (L + 1))
    for j in range(L):
        for m, q in enumerate(cfg.moduli):
            pe = _const(src, cfg.special_prime % q if m == j else 0)
            target = rt.addmod(rt.mulmod(src[m], pe, q), err[j, m], q)
            rows[2 * L * m + 2 * j] = rt.submod(
                target, rt.mulmod(kb[j, m], s_tgt.ntt[m], q), q)
            rows[2 * L * m + 2 * j + 1] = kb[j, m]
    return torch.stack(rows)


def galois_secret(sk: SecretKey, exp: int, cfg: HEConfig = DEFAULT_CONFIG):
    """Coefficients of s(X^exp) (exp odd), the negacyclic sign rule applied."""
    if exp % 2 == 0:
        raise ValueError("Galois exponent must be odd")
    n = cfg.n
    j = torch.arange(n, device=sk.coeff.device) * exp % (2 * n)
    out = torch.zeros_like(sk.coeff)
    out[j & (n - 1)] = torch.where(j >= n, -sk.coeff, sk.coeff)
    return out


def relin_secret(sk: SecretKey, cfg: HEConfig = DEFAULT_CONFIG):
    """Integer coefficients (N,) int64 of s^2 in the negacyclic ring, the
    source secret of the relinearization key.  Each is a sum of at most N
    products of ternary coefficients, so |s^2_i| <= N < q0/2 and the
    centred lift of INTT_{q0}(NTT(s)^2) gives the integers exactly (the JAX
    package sums the convolution on the host, aloha_tpu/keys.py:243-252)."""
    q = cfg.moduli[0]
    sq = rt.mulmod(sk.ntt[0], sk.ntt[0], q)
    c = ntt_stream.transform_limbs(sq[None], (q,), (cfg.ipsi[0],), True)[0]
    return torch.where(c > q // 2, c - q, c)


def encrypt_with(m_signed, sk: SecretKey, noise, b, cfg: HEConfig = DEFAULT_CONFIG):
    """Symmetric RLWE encryption of signed coefficients (..., N) from the
    draws of `draw_encryption`: a = NTT(m + e) - b s, limb by limb."""
    L = cfg.n_limbs
    msg = _ntt(_residues(m_signed + noise, cfg.moduli[:L]), cfg)
    a = torch.stack([
        rt.submod(msg[..., m, :], rt.mulmod(b[..., m, :], sk.ntt[m], q), q)
        for m, q in enumerate(cfg.moduli[:L])
    ], dim=-2)
    return a, b


def decrypt(ct, sk: SecretKey, cfg: HEConfig = DEFAULT_CONFIG, limb: int = 0):
    """Signed (centred) coefficients (..., N) of a + b s under one limb."""
    q = cfg.moduli[limb]
    a, b = ct
    m = rt.addmod(a[..., limb, :], rt.mulmod(b[..., limb, :], sk.ntt[limb], q), q)
    m = ntt_stream.transform_limbs(m[..., None, :], (q,), (cfg.ipsi[limb],), True)[..., 0, :]
    return torch.where(m > q // 2, m - q, m)


# ---------------------------------------------------------- draw + core
# generator=None draws from the OS (the JAX package's rng=None); the draws
# are made on the host and the cores run on the key's device.
def gen_secret(cfg: HEConfig = DEFAULT_CONFIG, generator: torch.Generator = None,
               device="cuda") -> SecretKey:
    """A secret key on `device` (the card unless the caller names another)."""
    return secret_key(draw_secret(cfg, generator).to(device), cfg)


def gen_ksk(s_src_coeff, s_tgt: SecretKey, cfg: HEConfig = DEFAULT_CONFIG,
            generator: torch.Generator = None):
    chunks, noise = draw_ksk(cfg, generator)
    dev = s_tgt.ntt.device
    return ksk_from_draws(s_src_coeff.to(dev), s_tgt, chunks.to(dev), noise.to(dev), cfg)


def gen_galois_key(sk: SecretKey, exp: int, cfg: HEConfig = DEFAULT_CONFIG,
                   generator: torch.Generator = None):
    """KSK for X -> X^exp: switches s(X^exp) back to s."""
    return gen_ksk(galois_secret(sk, exp, cfg), sk, cfg, generator)


def gen_rotation_key(sk: SecretKey, step: int, cfg: HEConfig = DEFAULT_CONFIG,
                     generator: torch.Generator = None):
    """KSK for the slot rotation by `step` (X -> X^(3^step))."""
    return gen_galois_key(sk, pow(3, step, 2 * cfg.n), cfg, generator)


def gen_conjugation_key(sk: SecretKey, cfg: HEConfig = DEFAULT_CONFIG,
                        generator: torch.Generator = None):
    """KSK for the slot conjugation (X -> X^(2N-1))."""
    return gen_galois_key(sk, 2 * cfg.n - 1, cfg, generator)


def gen_relin_key(sk: SecretKey, cfg: HEConfig = DEFAULT_CONFIG,
                  generator: torch.Generator = None):
    """KSK for relinearization: switches s^2 back to s."""
    return gen_ksk(relin_secret(sk, cfg), sk, cfg, generator)


def encrypt(m_signed, sk: SecretKey, cfg: HEConfig = DEFAULT_CONFIG,
            generator: torch.Generator = None):
    """Encrypt signed coefficients (..., N) on their device: (a, b), each
    (..., L, N).  A batch draws as that many single encryptions in
    row-major order (`draw_encryption`)."""
    e, b = draw_encryption(cfg, generator, m_signed.shape[:-1])
    dev = m_signed.device
    return encrypt_with(m_signed, sk, e.to(dev), b.to(dev), cfg)
