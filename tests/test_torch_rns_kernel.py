"""`ops/rns_kernel` and `rns_torch`'s routing, on the CPU.

`csrc/rns.cu` runs only on the card (tests/test_torch_rns_cuda.py holds it
there against the plain path).  Here the wrapper's kernel path runs on CPU
tensors with the launch replaced by a NumPy model of the kernel: it unpacks
the parameter block the wrapper hands over, reads each operand through its
raw pointer at the (r, l, j) offsets the kernel computes from a word's flat
index with the wrapper's dividers, checks the 16-byte layout wherever the
wrapper picked 16-byte units, and evaluates the kernel's u64 arithmetic
(modarith.cuh's `condsub`, `barrett`, `__umul64hi` on 32-bit halves).  That
model is held word for word against the plain path and `aloha_tpu.rns_np`
on edge and random uint64 words, every modulus of the configurations, L =
1-4 limbs, broadcast and strided operands and values a limb; the all-limbs
form's plain path against the per-limb loop; the launch count; and
he_torch's elementwise ops through the model against their CPU words.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aloha_tpu import rns_np
from aloha_tpu_torch import _build
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch import ntt_torch
from aloha_tpu_torch import rns_torch as rt
from aloha_tpu_torch.config import DEFAULT_CONFIG, MOD_WIDTH, HEConfig
from aloha_tpu_torch.ops import ks_kernel, ntt_mxu, ntt_pallas, ntt_stream, rns_kernel
from rns_cases import (BROADCAST_SHAPES, LAYOUTS, MODULI, P3, U64, VECTOR_LAYOUTS, drawer,
                       edges, tensor, words)

torch.set_num_threads(2)

ALU = ("lazy_reduce", "addmod", "submod", "mulmod", "modred")


def _u(t):
    return t.contiguous().numpy().view(U64)


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _flat(x)]


# ---------------------------------------------------------------- the model
def mulhi(a, b):
    """__umul64hi on uint64 arrays, from 32-bit halves."""
    m32 = U64(0xFFFFFFFF)
    a_lo, a_hi, b_lo, b_hi = a & m32, a >> U64(32), b & m32, b >> U64(32)
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> U64(32)) + (lh & m32) + (hl & m32)
    return hh + (lh >> U64(32)) + (hl >> U64(32)) + (mid >> U64(32))


def condsub(x, q):
    return np.where(x >= q, x - q, x)


def barrett(a, b, q, iq, w):
    """modarith.cuh's `barrett`."""
    w = int(w)
    lo, hi = a * b, mulhi(a, b)
    ps = (lo >> U64(w - 2)) | (hi << U64(64 - (w - 2)))
    ms = ((ps * iq) >> U64(w + 3)) | (mulhi(ps, iq) << U64(64 - (w + 3)))
    mask = U64((1 << (w + 1)) - 1)
    diff = (((lo & mask) | U64(1 << (w + 1))) - ((ms * q) & mask)) & mask
    return condsub(diff, q)


def apply(op, a, b, c, q, iq, w):
    """csrc/rns.cu's `apply<OP>` on uint64 arrays (q, iq a word each)."""
    with np.errstate(over="ignore"):
        if op == 0:
            return condsub(a, q)
        if op == 1:
            return condsub(condsub(a, q) + condsub(b, q), q)
        if op == 2:
            a, b = condsub(a, q), condsub(b, q)
            return np.where(a >= b, a - b, a + q - b)
        if op == 3:
            return barrett(condsub(a, q), condsub(b, q), q, iq, w)
        if op == 4:
            return barrett(condsub(a, q), np.ones_like(a), q, iq, w)
        if op == 5:
            half = (a.view(np.int64) >> 1).view(U64)
            return half + np.where(a & U64(1), (q + U64(1)) >> U64(1), U64(0))
        m62 = U64((1 << 62) - 1)
        return (a * b - (mulhi(a, c) & m62) * q) & m62


def _memory(ptr: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint64 * count).from_address(ptr))


def divide(x, magic: int, shift: int):
    """csrc/rns.cu's `divide` on uint64 arrays of x < 2^31."""
    s = ((x * U64(magic)) >> U64(32)) + x
    assert (s < U64(1 << 32)).all()  # the kernel adds in 32 bits
    return s >> U64(shift)


class Model:
    """aloha_rns(device, op, vec, params, stream) over CPU memory."""

    def __init__(self):
        self.calls = []

    def aloha_rns(self, device, op, vec, params, stream):
        f = rns_kernel._PARAMS.unpack(params)
        out_p, x, rest = f[0], [f[1 + 4 * k: 5 + 4 * k] for k in range(3)], f[13:]
        ml = rns_kernel.MAX_LIMBS
        q, iq = np.array(rest[:ml], U64), np.array(rest[ml:2 * ml], U64)
        v = np.array(rest[2 * ml:5 * ml], U64).reshape(3, ml)
        words, n, n_magic, n_shift, L, l_magic, l_shift, w = rest[5 * ml:]
        assert 0 < words < 1 << 31 and words % (n * L) == 0 and 1 <= L <= ml
        arity = rns_kernel.OPS[[k for k, c in rns_kernel.OPS.items() if c[0] == op][0]][1]
        self.calls.append((op, vec))
        e = np.arange(words, dtype=U64)
        row = divide(e, n_magic, n_shift)
        r = divide(row, l_magic, l_shift)
        limb, j = row - r * U64(L), e - row * U64(n)
        assert (r * U64(L * n) + limb * U64(n) + j == e).all()
        if vec == 2:
            assert n % 2 == 0 and out_p % 16 == 0
        ins = []
        for k in range(3):
            p, sr, sl, sn = x[k]
            if k >= arity or not p:
                ins.append(v[k][limb.astype(np.int64)])
                continue
            if vec == 2:
                assert sn == 1 and sr % 2 == 0 and sl % 2 == 0 and p % 16 == 0
            idx = (r.astype(np.int64) * sr + limb.astype(np.int64) * sl
                   + j.astype(np.int64) * sn)
            ins.append(_memory(p, int(idx.max()) + 1)[idx])
        li = limb.astype(np.int64)
        _memory(out_p, words)[:] = apply(op, *ins, q[li], iq[li], w)
        return 0


def _card_path(*operands):
    return True


@pytest.fixture
def card(monkeypatch):
    """rns_torch's card path on CPU tensors, the launch evaluated by `Model`."""
    model = Model()
    monkeypatch.setattr(rt, "_on_card", _card_path)
    monkeypatch.setattr(rns_kernel, "dispatch",
                        types.SimpleNamespace(use_kernel=lambda *t: True, stream_of=lambda t: 0))
    monkeypatch.setattr(_build, "lib", lambda: model)
    return model


@contextlib.contextmanager
def plain_path():
    """rns_torch's CPU path inside, whatever the `card` fixture routes."""
    saved = rt._on_card
    rt._on_card = lambda *operands: False
    try:
        yield
    finally:
        rt._on_card = saved


# ---------------------------------------------------------------- the tests
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 255, 256, 1000, 1024, 8191, 8192, 16384,
                               (1 << 20) + 1, (1 << 31) - 1])
def test_divider_divides_every_index_below_2_31(d):
    magic, shift = rns_kernel.divider(d)
    assert 0 < magic < 1 << 32 and 1 << shift >= d
    rng = np.random.default_rng(d)
    x = np.concatenate([np.arange(0, 1 << 12), rng.integers(0, 1 << 31, 1 << 14),
                        (1 << 31) - 1 - np.arange(1 << 12),
                        np.arange(1, 1 << 10) * d - 1, np.arange(1, 1 << 10) * d]).astype(U64)
    x = x[x < U64(1 << 31)]
    assert np.array_equal(divide(x, magic, shift), x // U64(d))


@pytest.mark.parametrize("q", MODULI)
@pytest.mark.parametrize("op", ALU + ("halfmod", "mulmod_shoup"))
def test_kernel_model_equals_the_plain_path_and_rns_np(op, q, card):
    """Word for word on edge words crossed and random uint64 patterns; the
    ALU ops also against `rns_np` (halfmod's plain `>>` is the int64 view's
    arithmetic shift, so `rns_np` is held below 2^63 only)."""
    a, b = words(q, seed=q % 1000)
    c = np.random.default_rng(1).integers(0, 1 << 64, a.size, dtype=U64)
    arity = rns_kernel.OPS[op][1]
    ops = [tensor(a), tensor(b), tensor(c)][:arity]
    fn = getattr(rt, op)
    with plain_path():
        want = _u(fn(*ops, q))
    got = _u(fn(*ops, q))
    assert card.calls == [(rns_kernel.OPS[op][0], 2)]
    assert np.array_equal(got, want)
    if op in ALU:
        assert np.array_equal(got, getattr(rns_np, op)(*[a, b][:arity], q))
    elif op == "halfmod":
        low = a < U64(1 << 63)
        assert np.array_equal(got[low], rns_np.halfmod(a[low], q))


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("op", ["addmod", "submod", "mulmod"])
def test_all_limbs_form_equals_the_per_limb_loop(op, L, card):
    """(B, L, N) under P3[:L]: the second operand a tensor, a plaintext
    expanded over the batch (stride 0) and values a limb; one launch each,
    equal to the per-limb loop of the plain path and to rns_np."""
    moduli = P3[:L]
    rng = np.random.default_rng(L)
    B, n = 3, 16
    x = rng.integers(0, 1 << 64, (B, L, n), dtype=U64)
    x[0, :, :11] = edges(moduli[0])
    y = rng.integers(0, 1 << 64, (B, L, n), dtype=U64)
    pt = rng.integers(0, 1 << 64, (L, n), dtype=U64)
    vals = tuple(int(v) for v in rng.integers(0, 1 << 64, L, dtype=U64))
    fn = getattr(rt, op)
    cases = [(tensor(y), y), (tensor(pt).expand(B, L, n), np.broadcast_to(pt, (B, L, n))),
             (vals, np.broadcast_to(np.array(vals, U64)[:, None], (B, L, n)))]
    for operand, y_np in cases:
        with plain_path():
            plain = _u(fn(tensor(x), operand, moduli))
            loop = np.stack([_u(fn(tensor(x[:, m]), tensor(np.ascontiguousarray(y_np[:, m])), q))
                             for m, q in enumerate(moduli)], axis=1)
        got = _u(fn(tensor(x), operand, moduli))
        oracle = np.stack([getattr(rns_np, op)(x[:, m], y_np[:, m], q)
                           for m, q in enumerate(moduli)], axis=1)
        assert np.array_equal(plain, loop) and np.array_equal(plain, oracle)
        assert np.array_equal(got, plain)
    assert card.calls == [(rns_kernel.OPS[op][0], 2)] * 3


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_strided_and_broadcast_operands(layout, card):
    x, y = LAYOUTS[layout](drawer(7))
    moduli = DEFAULT_CONFIG.moduli[:2]
    for op in ("addmod", "mulmod"):
        fn = getattr(rt, op)
        with plain_path():
            want = fn(x, y, moduli)
        got = fn(x, y, moduli)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want)
    vec = {v for _, v in card.calls}
    assert vec == ({2} if layout in VECTOR_LAYOUTS else {1})


@pytest.mark.parametrize("shape_x, shape_y", BROADCAST_SHAPES)
def test_one_modulus_over_any_broadcast_shape(shape_x, shape_y, card):
    rng = np.random.default_rng(3)
    q = DEFAULT_CONFIG.moduli[1]
    x = tensor(rng.integers(0, 1 << 64, shape_x, dtype=U64))
    y = tensor(rng.integers(0, 1 << 64, shape_y, dtype=U64))
    for op in ("submod", "mulmod"):
        fn = getattr(rt, op)
        with plain_path():
            want = fn(x, y, q)
        got = fn(x, y, q)
        assert got.shape == want.shape and torch.equal(got, want)
    assert len(card.calls) == (0 if 0 in shape_x else 2)


def test_shoup_with_int_twiddles_and_a_broadcast_table(card):
    """mulmod_shoup with Python int w and ws, and with (h, 1) table columns
    against (..., h, m) words, as a transform's butterflies take them."""
    q, rng = DEFAULT_CONFIG.moduli[0], np.random.default_rng(5)
    x = tensor(rng.integers(0, 1 << 62, (2, 4, 8), dtype=U64))
    w = rng.integers(0, q, (4, 1), dtype=U64)
    ws = np.array([(int(v) << 64) // q for v in w.ravel()], dtype=U64).reshape(4, 1)
    for args in [(x, 12345, (12345 << 64) // q), (x, tensor(w), tensor(ws))]:
        with plain_path():
            want = rt.mulmod_shoup(*args, q)
        assert torch.equal(rt.mulmod_shoup(*args, q), want)


def test_launches_follow_the_launches(card):
    x = tensor(np.arange(2 * 2 * 8, dtype=U64).reshape(2, 2, 8))
    moduli = DEFAULT_CONFIG.moduli[:2]
    before = rns_kernel.elementwise.launches
    ht.hom_add((x, x), (x, x), DEFAULT_CONFIG)
    rt.mulmod(x, (3, 5), moduli)
    rt.addmod(x[:0], x[:0], moduli)  # empty: no launch
    assert rns_kernel.elementwise.launches - before == 3 == len(card.calls)


def test_routing_raises_for_mixed_devices():
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="several devices"):
        rt.addmod(x, torch.zeros(4, dtype=torch.int64, device="meta"), 17)
    with pytest.raises(ValueError, match="several devices"):
        rt.mulmod_shoup(x, 3, torch.zeros(4, dtype=torch.int64, device="meta"), 17)


def test_kernel_path_refuses_what_it_cannot_take(card):
    x = torch.zeros(2, 5, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="1 to 4 limbs"):
        rt.addmod(x, x, (3, 5, 7, 11, 13))
    with pytest.raises(ValueError, match="limb axis"):
        rt.addmod(x, x, (3, 5))
    with pytest.raises(TypeError, match="dtype"):
        rt.addmod(x[:, :2], x[:, :2].to(torch.int32), (3, 5))
    with pytest.raises(ValueError, match="3 values for 2 limbs"):
        rt.mulmod(x[:, :2], (1, 2, 3), DEFAULT_CONFIG.moduli[:2])
    with pytest.raises(ValueError, match="Barrett width"):
        rt.mulmod(x, x, DEFAULT_CONFIG.moduli[0], w=62)
    assert not card.calls


N = 64
_K = DEFAULT_CONFIG.n // N
CFG = HEConfig(n=N, moduli=DEFAULT_CONFIG.moduli,
               psi=tuple(pow(p, _K, q) for p, q in zip(DEFAULT_CONFIG.psi, DEFAULT_CONFIG.moduli)),
               ipsi=tuple(pow(p, _K, q)
                          for p, q in zip(DEFAULT_CONFIG.ipsi, DEFAULT_CONFIG.moduli)))


def _ct(seed, batch=3, L=2):
    rng = np.random.default_rng(seed)
    return tuple(tensor(rng.integers(0, min(CFG.moduli), (batch, L, N), dtype=U64))
                 for _ in range(2))


#: he_torch's elementwise ops, and the rns ops each launches on the card
HE_OPS = {
    "hom_add": (lambda ct, ct2, pt: ht.hom_add(ct, ct2, CFG), ["addmod"] * 2),
    "hom_sub": (lambda ct, ct2, pt: ht.hom_sub(ct, ct2, CFG), ["submod"] * 2),
    "add_plain": (lambda ct, ct2, pt: ht.add_plain(ct, pt, CFG), ["addmod"]),
    "mul_plain": (lambda ct, ct2, pt: ht.mul_plain(ct, pt, CFG), ["mulmod"] * 2),
    "ct_mul": (lambda ct, ct2, pt: ht.ct_mul(ct, ct2, CFG), ["mulmod"] * 2 + ["addmod"]
               + ["mulmod"] * 2),
    "rescale": (lambda ct, ct2, pt: ht.rescale(ct, CFG),
                ["addmod", "submod"] + ["submod", "mulmod"] * 2),
}


@pytest.mark.parametrize("op", sorted(HE_OPS))
def test_he_torch_stages_through_the_kernel_equal_the_cpu_words(op, card, monkeypatch):
    """One launch a stage over every limb, no per-limb stack, under each
    stage's `aloha.rns.*` span one `aloha.kernel.rns` range (the rescale's
    transforms kept on their CPU path)."""
    transform_limbs = ht.ntt_stream.transform_limbs

    def cpu_transform(*args):
        with plain_path():
            return transform_limbs(*args)

    monkeypatch.setattr(ht.ntt_stream, "transform_limbs", cpu_transform)
    fn, stages = HE_OPS[op]
    ct, ct2 = _ct(1), _ct(2)
    pt = _ct(3, batch=1)[0][0]
    with plain_path():
        want = fn(ct, ct2, pt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn(ct, ct2, pt)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want), strict=True))
    assert [c for c, _ in card.calls] == [rns_kernel.OPS[s][0] for s in stages]
    events = [e for e in prof.events() if e.name.startswith("aloha.")]
    kernels = [e for e in events if e.name == "aloha.kernel.rns"]
    assert [e.cpu_parent.name for e in kernels] == [f"aloha.rns.{s}" for s in stages]
    assert not any(e.name in ("aloha.pack.per_limb", "aloha.pack.scalar_per_limb")
                   for e in events)


def test_mulmod_width_reaches_the_kernel(card):
    """mulmod's Barrett width w is the kernel's (modred keeps MOD_WIDTH)."""
    q = DEFAULT_CONFIG.moduli[0]
    a, b = words(q, seed=9, size=64)
    for w in (59, MOD_WIDTH):
        with plain_path():
            want = rt.mulmod(tensor(a), tensor(b), q, w=w)
        assert torch.equal(rt.mulmod(tensor(a), tensor(b), q, w=w), want)


@pytest.mark.parametrize("shapes", [[(3, 2, 8)], [(3, 2, 8), (2, 8)], [(3, 1, 8), (1, 2, 1)],
                                    [(), (5,)], [(0, 8), (8,)], [(4, 1), (1, 0)],
                                    [(2, 3), (3, 2)]])
def test_broadcast_shape_follows_torch_without_calling_it(shapes, card, monkeypatch):
    """rns_kernel.broadcast_shape gives torch.broadcast_shapes' shape (and
    raises where it does), and neither path of the rns ops calls it: its
    first call imports sympy, seconds of a process's set-up."""
    tensors = [torch.zeros(s, dtype=torch.int64) for s in shapes]
    try:
        want = torch.broadcast_shapes(*shapes)
    except RuntimeError:
        with pytest.raises(ValueError, match="do not broadcast"):
            rns_kernel.broadcast_shape(tensors)
        return
    assert rns_kernel.broadcast_shape(tensors) == want

    def refuse(*args):
        raise AssertionError("torch.broadcast_shapes called")

    monkeypatch.setattr(torch, "broadcast_shapes", refuse)
    if len(want) >= 2 and want[-2] == 2 and all(t.dim() >= 1 for t in tensors):
        moduli = DEFAULT_CONFIG.moduli[:2]
        y = tensors[-1]
        rt.addmod(tensors[0], y, moduli)
        with plain_path():
            rt.addmod(tensors[0], y, moduli)
    rt.submod(tensors[0], tensors[-1], DEFAULT_CONFIG.moduli[0])


def _tables_plain(x, inverse):
    w, ws, _ = ntt_torch.tables(N, CFG.moduli[:1], (CFG.ipsi if inverse else CFG.psi)[:1],
                                x.device)
    return ntt_stream.transform_with_tables_plain(x[0], w[0], ws[0], CFG.moduli[0], inverse)


def _tail_plain(x):
    L = CFG.n_limbs
    key = tensor(np.random.default_rng(6).integers(0, min(CFG.moduli), (2 * L * (L + 1), N),
                                                   dtype=U64))
    b = x.transpose(0, 1)
    return ks_kernel.ks_tail_plain(ks_kernel.ks_head_plain(b, None, CFG), b, key, CFG)


#: the port's plain references (x: (3, L, N) canonical words); none may
#: launch on the card path's routing
REFERENCES = {
    "ntt_torch.ntt": lambda x: ntt_torch.ntt(x[0], CFG.moduli[0], CFG.psi[0]),
    "ntt_torch.intt": lambda x: ntt_torch.intt(x[0], CFG.moduli[1], CFG.ipsi[1]),
    "ntt_stream.transform_plain": lambda x: ntt_stream.transform_plain(
        x.transpose(0, 1), CFG.moduli[:2], CFG.psi[:2], False),
    "ntt_stream.transform_with_tables_plain": lambda x: torch.stack(
        [_tables_plain(x, False), _tables_plain(x, True)]),
    "ntt_pallas.ntt_plain": lambda x: ntt_pallas.ntt_plain(x[0], CFG.moduli[2], CFG.psi[2]),
    "ks_kernel.ks_head_plain": lambda x: ks_kernel.ks_head_plain(x.transpose(0, 1), 5, CFG),
    "ks_kernel.ks_tail_plain": _tail_plain,
    "ntt_mxu.transform_plain": lambda x: ntt_mxu.transform_plain(
        x[:2].reshape(1, 1, 256), CFG.moduli[:1],
        (pow(DEFAULT_CONFIG.psi[0], DEFAULT_CONFIG.n // 256, CFG.moduli[0]),), False),
}


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_plain_references_never_reach_the_kernel(ref, card):
    """The references the kernels are held against stay aten code where the
    entry points would launch `csrc/rns.cu`: their words equal the CPU
    path's, and no launch is made."""
    x = _ct(5)[0]
    with plain_path():
        want = REFERENCES[ref](x)
    before = rns_kernel.elementwise.launches
    got = REFERENCES[ref](x)
    assert not card.calls and rns_kernel.elementwise.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", sorted(rns_kernel.OPS))
def test_plain_entry_points_equal_the_routed_cpu_path(op, card):
    """`rns_torch.plain.<op>` gives the CPU path's words on the card path's
    routing, with no launch, under the entry point's `aloha.rns.<op>` span
    and nothing else of the family."""
    q = P3[1]
    a, b = words(q, seed=11, size=64)
    c = np.random.default_rng(2).integers(0, 1 << 64, a.size, dtype=U64)
    operands = [tensor(a).view(2, 1, -1), tensor(b).view(2, 1, -1),
                tensor(c).view(2, 1, -1)][:rns_kernel.OPS[op][1]]
    for moduli in (q, (q,)):
        with plain_path():
            want = getattr(rt, op)(*operands, moduli)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = getattr(rt.plain, op)(*operands, moduli)
        assert torch.equal(got, want)
        names = [e.name for e in prof.events() if e.name.startswith("aloha.rns.")]
        assert names == [f"aloha.rns.{op}"]
    assert not card.calls
