"""`csrc/rns.cu` against rns_torch's plain path, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file imports
no JAX:

    python -m pytest tests/test_torch_rns_cuda.py -m cuda --noconftest -q

Each op of the kernel is held word for word (torch.equal) against the
plain path: on CPU tensors for the edge words 0, 1, q-1, q, q+1, 2q-1, 2q,
2^60-1, 2^63-1, 2^63 and 2^64-1 crossed and seeded random uint64 patterns
under every modulus of the configurations; and, at L = 1-4 limbs, n = 2-16384
and batches 1-264, against the plain path's aten code on the same card
tensors, with the second operand a tensor, a plaintext expanded over the
batch (stride 0) and one value a limb.
"""

import numpy as np
import pytest
import torch

from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG
from aloha_tpu_torch.ops import rns_kernel
from rns_cases import BROADCAST_SHAPES, LAYOUTS, MODULI, P3, U64, drawer, tensor, words

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


def plain(op, q, *operands):
    """rns_torch's plain path on the operands' device (aten on the card)."""
    kw = {"w": DEFAULT_CONFIG.mod_width} if op == "mulmod" else {}
    return getattr(rt.plain, op)(*operands, q, **kw)


@pytest.mark.parametrize("q", MODULI)
@pytest.mark.parametrize("op", sorted(rns_kernel.OPS))
def test_edge_and_random_words_equal_the_cpu(op, q, dev):
    a, b = words(q, seed=q % 997, size=4096)
    c = np.random.default_rng(q % 991).integers(0, 1 << 64, a.size, dtype=U64)
    arity = rns_kernel.OPS[op][1]
    fn = getattr(rt, op)
    for cut in (a.size, a.size - 1):  # 16-byte units, and single words
        xs = [x[:cut] for x in (a, b, c)][:arity]
        before = rns_kernel.elementwise.launches
        got = fn(*[tensor(x, dev) for x in xs], q)
        assert rns_kernel.elementwise.launches == before + 1
        assert torch.equal(got.cpu(), fn(*[tensor(x) for x in xs], q)), (op, q, cut)


@pytest.mark.parametrize("batch", [1, 3, 264])
@pytest.mark.parametrize("n", [2, 64, 1024, 8192, 16384])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_all_limbs_at_every_ring_and_batch(L, n, batch, dev):
    """The binary ops with a tensor, a stride-0 plaintext and values a limb,
    the unary ops and the Shoup product, under P3[:L]."""
    moduli = P3[:L]
    draw = drawer(L * 100003 + n + batch, dev)

    x = draw(batch, L, n)
    seconds = [draw(batch, L, n), draw(L, n).expand(batch, L, n),
               tuple(int(v) % (1 << 64) for v in draw(L).cpu())]
    for op in ("addmod", "submod", "mulmod"):
        for y in seconds:
            assert torch.equal(getattr(rt, op)(x, y, moduli), plain(op, moduli, x, y)), (op, y)
    for op in ("lazy_reduce", "modred", "halfmod"):
        assert torch.equal(getattr(rt, op)(x, moduli), plain(op, moduli, x)), op
    w, ws = draw(L, n).expand(batch, L, n), draw(batch, L, n)
    assert torch.equal(rt.mulmod_shoup(x, w, ws, moduli), plain("mulmod_shoup", moduli, x, w, ws))


def test_strided_views_and_broadcasts(dev):
    """Every layout of `rns_cases.LAYOUTS` under two moduli, and every
    shape pair of `BROADCAST_SHAPES` under one."""
    draw = drawer(7, dev)
    moduli = DEFAULT_CONFIG.moduli[:2]
    for layout, build in LAYOUTS.items():
        x, y = build(draw)
        for op in ("addmod", "mulmod"):
            got = getattr(rt, op)(x, y, moduli)
            assert got.is_contiguous() and torch.equal(got, plain(op, moduli, x, y)), layout
    q = DEFAULT_CONFIG.moduli[1]
    for shape_x, shape_y in BROADCAST_SHAPES:
        x, y = draw(*shape_x), draw(*shape_y)
        assert torch.equal(rt.submod(x, y, q), plain("submod", q, x, y))


def test_he_torch_stages_are_one_launch_each(dev):
    """hom_add, mul_plain, ct_mul and rescale on B = 4 ciphertexts at
    N = 8192: one launch a stage, words equal to the CPU."""
    L, n = DEFAULT_CONFIG.n_limbs, DEFAULT_CONFIG.n
    rng = np.random.default_rng(11)

    def ct():
        return tuple(tensor(rng.integers(0, min(DEFAULT_CONFIG.moduli), (4, L, n), dtype=U64))
                     for _ in range(2))

    c1, c2 = ct(), ct()
    pt = tensor(rng.integers(0, min(DEFAULT_CONFIG.moduli), (L, n), dtype=U64))
    on = [tuple(t.to(dev) for t in c) for c in (c1, c2)]
    cases = [(lambda a, b, p: ht.hom_add(a, b), 2), (lambda a, b, p: ht.mul_plain(a, p), 2),
             (lambda a, b, p: ht.ct_mul(a, b), 5), (lambda a, b, p: ht.rescale(a), 6)]
    for fn, stages in cases:
        before = rns_kernel.elementwise.launches
        got = fn(*on, pt.to(dev))
        assert rns_kernel.elementwise.launches - before == stages
        want = fn(c1, c2, pt)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want, strict=True))
