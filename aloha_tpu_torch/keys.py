"""Key generation, encryption and decryption on int64 tensors.

The port of `aloha_tpu/keys.py:89-291`.  Each function is a drawing step
(`draw_*`, random numbers from an explicit `torch.Generator` only) and a
deterministic core that turns the draws into keys or ciphertexts through
`rns_torch` and the NTT wrapper `ops.ntt_stream` (so on the card key
generation and encryption launch the NTT kernel).  The cores are held word
for word against the JAX package's functions on the same draws
(tests/test_torch_host.py).

Key-switch keys come in the accelerator's memory layout, (2L(L+1), N)
ordered [m0d0a, m0d0b, m0d1a, m0d1b, ..., m1d0a, ...]: per modulus the L
digits' (a, b) pairs, stride 2L (reference: sim/top/top_noaxilite_tb.sv:
372-393), with ka_j + kb_j s_tgt == P e_j s_src + err under every modulus.
A ciphertext is (a, b), decrypting as a + b s.
"""

from __future__ import annotations

import dataclasses
import math

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


def uniform_chunks(cfg: HEConfig) -> int:
    """63-bit chunks per coefficient of a uniform integer mod prod(moduli),
    with 128 bits of slack (modular bias < 2^-128)."""
    bits = math.prod(cfg.moduli).bit_length()
    return (bits + 128 + 62) // 63


# ------------------------------------------------------------------- draws
def draw_secret(cfg: HEConfig, generator: torch.Generator) -> torch.Tensor:
    """Ternary secret coefficients (N,) int64 in {-1, 0, 1}."""
    return torch.randint(-1, 2, (cfg.n,), generator=generator,
                         dtype=torch.int64, device=generator.device)


def draw_noise(cfg: HEConfig, generator: torch.Generator, lead=()) -> torch.Tensor:
    """Rounded Gaussian error polynomials (*lead, N) int64, sigma = SIGMA."""
    g = torch.normal(0.0, SIGMA, tuple(lead) + (cfg.n,), generator=generator,
                     dtype=torch.float64, device=generator.device)
    return torch.round(g).to(torch.int64)  # half to even, as np.rint


def draw_uniform(cfg: HEConfig, generator: torch.Generator, lead=()) -> torch.Tensor:
    """(*lead, chunks, N) int64 words in [0, 2^63): the chunks of uniform
    integer polynomials mod prod(moduli), low chunk first."""
    shape = tuple(lead) + (uniform_chunks(cfg), cfg.n)
    return torch.empty(shape, dtype=torch.int64,
                       device=generator.device).random_(generator=generator)


def draw_ksk(cfg: HEConfig, generator: torch.Generator):
    """The draws of one key-switch key, digit by digit: (chunks (L, c, N),
    noise (L, N))."""
    per = [(draw_uniform(cfg, generator), draw_noise(cfg, generator))
           for _ in range(cfg.n_limbs)]
    return torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])


def draw_encryption(cfg: HEConfig, generator: torch.Generator, lead=()):
    """The draws of encryptions of shape lead: (noise (*lead, N), b
    (*lead, L, N) uniform residues, the NTT-domain b-parts)."""
    e = draw_noise(cfg, generator, lead)
    b = torch.stack([
        torch.randint(0, q, tuple(lead) + (cfg.n,), generator=generator,
                      dtype=torch.int64, device=generator.device)
        for q in cfg.moduli[:cfg.n_limbs]
    ], dim=-2)
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
def gen_secret(cfg: HEConfig, generator: torch.Generator, device) -> SecretKey:
    return secret_key(draw_secret(cfg, generator).to(device), cfg)


def gen_ksk(s_src_coeff, s_tgt: SecretKey, cfg: HEConfig, generator: torch.Generator):
    chunks, noise = draw_ksk(cfg, generator)
    dev = s_tgt.ntt.device
    return ksk_from_draws(s_src_coeff.to(dev), s_tgt, chunks.to(dev), noise.to(dev), cfg)


def gen_galois_key(sk: SecretKey, exp: int, cfg: HEConfig, generator: torch.Generator):
    """KSK for X -> X^exp: switches s(X^exp) back to s."""
    return gen_ksk(galois_secret(sk, exp, cfg), sk, cfg, generator)


def gen_rotation_key(sk: SecretKey, step: int, cfg: HEConfig, generator: torch.Generator):
    """KSK for the slot rotation by `step` (X -> X^(3^step))."""
    return gen_galois_key(sk, pow(3, step, 2 * cfg.n), cfg, generator)


def gen_conjugation_key(sk: SecretKey, cfg: HEConfig, generator: torch.Generator):
    """KSK for the slot conjugation (X -> X^(2N-1))."""
    return gen_galois_key(sk, 2 * cfg.n - 1, cfg, generator)


def gen_relin_key(sk: SecretKey, cfg: HEConfig, generator: torch.Generator):
    """KSK for relinearization: switches s^2 back to s."""
    return gen_ksk(relin_secret(sk, cfg), sk, cfg, generator)


def encrypt(m_signed, sk: SecretKey, cfg: HEConfig, generator: torch.Generator):
    """Encrypt signed coefficients (..., N) on their device: (a, b), each
    (..., L, N)."""
    e, b = draw_encryption(cfg, generator, m_signed.shape[:-1])
    dev = m_signed.device
    return encrypt_with(m_signed, sk, e.to(dev), b.to(dev), cfg)
