"""The plain reference: its products and transforms against their
definitions, and against the system's plain CPU path on one request of each
kind at B = 1, at the configurations' own ring."""

from __future__ import annotations

import random

import pytest
import torch

from portbench import harness
from portbench.reference import ntt, zq
from portbench.tests.conftest import cell_names, small_root

MODULI = harness.load_cell("matvec16.b256").ring.moduli


@pytest.mark.parametrize("q", MODULI)
def test_products(q):
    rnd = random.Random(q)
    edge = [0, 1, q - 1, q - 2, (1 << 30) - 1, 1 << 30, (1 << 30) + 1, q // 2, (q + 1) // 2]
    a = [rnd.randrange(q) for _ in range(5000)] + [x for x in edge for _ in edge]
    b = [rnd.randrange(q) for _ in range(5000)] + [y for _ in edge for y in edge]
    ta, tb = torch.tensor(a), torch.tensor(b)
    want = torch.tensor([x * y % q for x, y in zip(a, b)])
    assert torch.equal(zq.Zq().mul(ta, tb, q), want)
    for c in (0, 1, 12345, 1 << 30, (1 << 30) + 3, q - 1, q + 5):
        assert torch.equal(zq.Zq().mul(ta, c, q), torch.tensor([x * c % q for x in a]))
    assert not torch.equal(zq.Zq(exact=False).mul(ta, tb, q), want)


def test_modulus_range():
    zq.check_modulus(zq.MAX_MODULUS)
    zq.check_modulus(zq.MIN_MODULUS)
    for q in (zq.MAX_MODULUS + 1, zq.MIN_MODULUS - 1):
        with pytest.raises(ValueError):
            zq.check_modulus(q)


@pytest.mark.parametrize("q", MODULI)
def test_transform_is_the_definition(q):
    """A[k] = sum_j a_j psi^((2 rev(k) + 1) j) at n = 16, and back."""
    n, cell = 16, harness.load_cell("matvec16.b256")
    psi = pow(cell.ring.psi[cell.ring.moduli.index(q)], cell.ring.n // n, q)
    t = ntt.Transforms(n, (q,), (psi,), "cpu", zq.Zq())
    a = [random.Random(n).randrange(q) for _ in range(n)]
    rev = ntt.bitrev(n)
    want = [sum(x * pow(psi, (2 * int(rev[k]) + 1) * j, q) for j, x in enumerate(a)) % q
            for k in range(n)]
    got = t.ntt(torch.tensor(a), q)
    assert got.tolist() == want
    assert t.intt(got, q).tolist() == a


def test_automorphisms_agree():
    """The gather on values is the automorphism on coefficients."""
    cell = harness.load_cell("matvec16.b256")
    n, q = 64, cell.ring.moduli[0]
    psi = pow(cell.ring.psi[0], cell.ring.n // n, q)
    t = ntt.Transforms(n, (q,), (psi,), "cpu", zq.Zq())
    x = torch.randint(0, q, (3, n), generator=torch.Generator().manual_seed(1))
    for e in (3, 9, 2 * n - 1):
        coeff = ntt.coeff_automorphism(x, e, q) % q
        assert torch.equal(t.ntt(coeff, q), ntt.eval_automorphism(t.ntt(x, q), e))


@pytest.mark.parametrize("cell", cell_names())
def test_reference_against_the_system_at_b1(cell, tmp_path):
    """One request of B = 1 at the configuration's own ring: the system's
    plain CPU path word for word equal to the reference's answer."""
    root = small_root(tmp_path, n=harness.load_cell(cell).ring.n, batch=1, pool=1,
                      keep={"sampled": 0, "last": 1})
    r = harness.run(harness.load_cell(cell, root), 2 ** 31 + 7, 0.0, False, "cpu",
                    0.0, log=lambda m: None)
    assert r["correct"], r
    assert r["checks"]["mismatched_words"]["value"] == 0
    assert r["attempted"] == 1
