"""Leveled RNS-CKKS from its definitions: keys, encryption, and the operations
of a request.

A ciphertext is (a, b), each (..., L, n): residues under the L ciphertext
moduli, in the transformed domain of `ntt.Transforms`; it decrypts as
a + b s.  A key-switch key is (2L(L+1), n), row 2L m + 2j + p holding part p
of digit j under modulus m (the last modulus is the special prime P):
ka_j + kb_j s_tgt = P e_j s_src + err_j, where e_j is 1 under q_j and 0
under every other modulus.

The key-switch of a polynomial x from s_src to s_tgt:
  1. digits d_j = the coefficients of x under q_j, integers in [0, q_j];
  2. each digit, as an integer, reduced under every modulus and transformed;
  3. inner products y_{m,p} = sum_j d_j k_{m,j,p} under each modulus m;
  4. division by P with rounding: c = y_P's coefficients lifted to
     (-P/2, P/2), then (y_m - c) P^-1 under each q_m.

A rotation by r slots is the automorphism X -> X^e, e = 3^r mod 2n, and a
key-switch of its b-part from s(X^e) back to s.  The system computes it in
two forms whose words differ, both specified here:
  * `rotate`: the automorphism on b's coefficients first, a coefficient that
    changes sign written as q - x (so 0 becomes q); its digits are those
    integers;
  * `rotate_lazy` (the hoisted and batched rotations): the digits of b
    itself, the key's values permuted by X -> X^(e^-1), the result (with a
    added) permuted by X -> X^e.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import ntt as nt
from portbench.reference import zq


@dataclasses.dataclass(frozen=True)
class Ring:
    """A configuration's ring: degree n, the L ciphertext moduli then P."""

    n: int
    moduli: tuple
    psi: tuple

    @property
    def L(self) -> int:
        return len(self.moduli) - 1

    @property
    def P(self) -> int:
        return self.moduli[-1]


def _centred(c, q: int):
    return torch.where(c > (q - 1) // 2, c - q, c)


class Scheme:
    """The reference's operations on one device, products exact or in
    float64 (the control)."""

    def __init__(self, ring: Ring, device, exact: bool = True):
        self.ring, self.zq = ring, zq.Zq(exact)
        self.t = nt.Transforms(ring.n, ring.moduli, ring.psi, device, self.zq)

    # ------------------------------------------------------------ helpers
    def mul(self, a, b, q):
        return self.zq.mul(a, b, q)

    def limbs(self, f, *xs):
        """Stack f(x[..., m, :] ..., q_m) over the limbs."""
        moduli = self.ring.moduli[:xs[0].shape[-2]]
        return torch.stack([f(*(x[..., m, :] for x in xs), q) for m, q in enumerate(moduli)],
                           dim=-2)

    def transform(self, signed, moduli):
        """Signed integer coefficients (..., n) -> values (..., M, n)."""
        return torch.stack([self.t.ntt(torch.remainder(signed, q), q) for q in moduli], dim=-2)

    # --------------------------------------------------------------- keys
    def secret(self, coeff):
        """Ternary coefficients (n,) -> s's values under every modulus (M, n)."""
        return self.transform(coeff, self.ring.moduli)

    def galois_secret(self, coeff, e: int):
        """Coefficients of s(X^e) over the integers."""
        n = self.ring.n
        j = torch.arange(n, device=coeff.device) * e % (2 * n)
        out = torch.empty_like(coeff)
        out[j % n] = torch.where(j >= n, -coeff, coeff)
        return out

    def relin_secret(self, s):
        """Coefficients of s^2 over the integers (|s^2_i| <= n < q0 / 2)."""
        q = self.ring.moduli[0]
        return _centred(self.t.intt(self.mul(s[0], s[0], q), q), q)

    def uniform(self, chunks, q: int):
        """chunks (..., c, n) of 63-bit words -> sum_k chunks[k] 2^(63k) mod q."""
        radix = (1 << 63) % q
        r = torch.remainder(chunks[..., -1, :], q)
        for k in range(chunks.shape[-2] - 2, -1, -1):
            r = zq.add(self.mul(r, radix, q), torch.remainder(chunks[..., k, :], q), q)
        return r

    def ksk(self, src_coeff, s, chunks, noise):
        """Key switching from src to s from the draws: chunks (L, c, n) of
        each digit's uniform kb, noise (L, n) of its error."""
        ring, L = self.ring, self.ring.L
        src = self.transform(src_coeff, ring.moduli)
        rows = [None] * (2 * L * (L + 1))
        for j in range(L):
            err = self.transform(noise[j], ring.moduli)
            for m, q in enumerate(ring.moduli):
                kb = self.t.ntt(self.uniform(chunks[j], q), q)
                target = err[m]
                if m == j:
                    target = zq.add(self.mul(src[m], ring.P % q, q), target, q)
                rows[2 * L * m + 2 * j] = zq.sub(target, self.mul(kb, s[m], q), q)
                rows[2 * L * m + 2 * j + 1] = kb
        return torch.stack(rows)

    # ------------------------------------------------- encryption, decryption
    def encrypt(self, message, s, noise, b):
        """message, noise (..., n) signed; b (..., L, n) uniform values."""
        moduli = self.ring.moduli[:self.ring.L]
        m = self.transform(message + noise, moduli)
        a = torch.stack([zq.sub(m[..., j, :], self.mul(b[..., j, :], s[j], q), q)
                         for j, q in enumerate(moduli)], dim=-2)
        return a, b

    def decrypt(self, ct, s):
        """Signed coefficients (..., n) of a + b s under q0."""
        q = self.ring.moduli[0]
        a, b = ct
        v = zq.add(a[..., 0, :], self.mul(b[..., 0, :], s[0], q), q)
        return _centred(self.t.intt(v, q), q)

    # ----------------------------------------------------------- operations
    def add(self, x, y):
        return tuple(self.limbs(zq.add, u, v) for u, v in zip(x, y))

    def mul_plain(self, ct, pt):
        return tuple(self.limbs(self.mul, u, pt.expand_as(u)) for u in ct)

    def ct_mul(self, x, y):
        """(a1 a2, a1 b2 + b1 a2, b1 b2): decrypts as d0 + d1 s + d2 s^2."""
        (a1, b1), (a2, b2) = x, y
        m = lambda u, v: self.limbs(self.mul, u, v)  # noqa: E731
        return m(a1, a2), self.limbs(zq.add, m(a1, b2), m(b1, a2)), m(b1, b2)

    def keyswitch(self, digits, key):
        """Integer digits [d_j (..., n)] -> (part 0, part 1), each (..., L, n)."""
        ring, L = self.ring, self.ring.L
        y = []
        for m, q in enumerate(ring.moduli):
            raised = [self.t.ntt(torch.remainder(d, q), q) for d in digits]
            y.append([self._inner(raised, key, m, p, q) for p in (0, 1)])
        out = []
        for p in (0, 1):
            c = _centred(self.t.intt(y[L][p], ring.P), ring.P)
            out.append(torch.stack([
                self.mul(zq.sub(y[m][p], self.t.ntt(torch.remainder(c, q), q), q),
                         pow(ring.P, -1, q), q)
                for m, q in enumerate(ring.moduli[:L])], dim=-2))
        return tuple(out)

    def _inner(self, raised, key, m, p, q):
        L = self.ring.L
        acc = None
        for j, d in enumerate(raised):
            t = self.mul(d, key[2 * L * m + 2 * j + p], q)
            acc = t if acc is None else zq.add(acc, t, q)
        return acc

    def rotate(self, ct, e: int, key):
        """X -> X^e and a key-switch, the automorphism on b's coefficients."""
        a, b = ct
        moduli = self.ring.moduli[:self.ring.L]
        digits = [nt.coeff_automorphism(self.t.intt(b[..., j, :], q), e, q)
                  for j, q in enumerate(moduli)]
        ka, kb = self.keyswitch(digits, key)
        return self.limbs(zq.add, nt.eval_automorphism(a, e), ka), kb

    def rotate_lazy(self, ct, e: int, key):
        """X -> X^e and a key-switch in the hoisted form: b's own digits, the
        key permuted by X -> X^(e^-1), the result permuted by X -> X^e."""
        a, b = ct
        n = self.ring.n
        moduli = self.ring.moduli[:self.ring.L]
        digits = [self.t.intt(b[..., j, :], q) for j, q in enumerate(moduli)]
        ka, kb = self.keyswitch(digits, nt.eval_automorphism(key, pow(e, -1, 2 * n)))
        return (nt.eval_automorphism(self.limbs(zq.add, a, ka), e),
                nt.eval_automorphism(kb, e))

    def relinearize(self, d0, d1, d2, rlk):
        moduli = self.ring.moduli[:self.ring.L]
        digits = [self.t.intt(d2[..., j, :], q) for j, q in enumerate(moduli)]
        ka, kb = self.keyswitch(digits, rlk)
        return self.limbs(zq.add, d0, ka), self.limbs(zq.add, d1, kb)

    def rescale(self, ct):
        """Divide by the last ciphertext modulus with rounding, dropping it."""
        L = self.ring.L
        ql = self.ring.moduli[L - 1]
        out = []
        for x in ct:
            c = _centred(self.t.intt(x[..., L - 1, :], ql), ql)
            out.append(torch.stack([
                self.mul(zq.sub(x[..., m, :], self.t.ntt(torch.remainder(c, q), q), q),
                         pow(ql, -1, q), q)
                for m, q in enumerate(self.ring.moduli[:L - 1])], dim=-2))
        return tuple(out)


def rotation_exponent(step: int, n: int) -> int:
    """The Galois exponent of a rotation by `step` slots: 3^step mod 2n."""
    return pow(3, step % (n // 2), 2 * n)
