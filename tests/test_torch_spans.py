"""The port's spans (`profiling.span`) on the CPU, at a small ring.

Off (no profiler recording), a span opens no range and changes no word;
under `torch.profiler` every served `he_torch` op is an `aloha.he.*` range
with the limb arithmetic, layout copies and gathers it ran nested inside
it, and a cache filled anew is an `aloha.build.*` range on a miss only.
The card case counts the `aloha.kernel.*` ranges of one matvec16-shaped
request against the wrappers' `.launches`.
"""

import collections
import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aloha_tpu_torch import _build, he_torch as ht, ntt_torch, profiling
from aloha_tpu_torch.config import DEFAULT_CONFIG, HEConfig
from aloha_tpu_torch.ops import aut, ks_kernel, ntt_mxu, ntt_pallas, ntt_stream, rns_kernel

torch.set_num_threads(2)

N, B = 256, 2
_K = DEFAULT_CONFIG.n // N
CFG = HEConfig(n=N, moduli=DEFAULT_CONFIG.moduli,
               psi=tuple(pow(p, _K, q) for p, q in zip(DEFAULT_CONFIG.psi, DEFAULT_CONFIG.moduli)),
               ipsi=tuple(pow(p, _K, q) for p, q in zip(DEFAULT_CONFIG.ipsi, DEFAULT_CONFIG.moduli)))
L = CFG.n_limbs
CPU = torch.device("cpu")
#: the families a served op's children belong to
CHILDREN = ("aloha.rns.", "aloha.pack.", "aloha.gather.", "aloha.kernel.", "aloha.build.")


def _words(*shape, seed, device=CPU):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, min(CFG.moduli), shape, generator=g, dtype=torch.int64).to(device)


def _operands(device=CPU, batch=B):
    ct = (_words(batch, L, N, seed=1, device=device), _words(batch, L, N, seed=2, device=device))
    ct2 = (_words(batch, L, N, seed=3, device=device), _words(batch, L, N, seed=4, device=device))
    key = {s: _words(2 * L * (L + 1), N, seed=10 + s, device=device) for s in (1, 2, 3, 4, 8, 12)}
    diags = [_words(L, N, seed=100 + k, device=device) for k in range(16)]
    return ct, ct2, _words(L, N, seed=5, device=device), key, diags


#: each served op on the operands, and the children it must show
SERVED = {
    "hom_add": (lambda ct, ct2, pt, key, diags: ht.hom_add(ct, ct2, CFG),
                ("aloha.rns.addmod", "aloha.pack.per_limb")),
    "hom_sub": (lambda ct, ct2, pt, key, diags: ht.hom_sub(ct, ct2, CFG),
                ("aloha.rns.submod", "aloha.pack.per_limb")),
    "add_plain": (lambda ct, ct2, pt, key, diags: ht.add_plain(ct, pt, CFG),
                  ("aloha.rns.addmod", "aloha.pack.per_limb")),
    "mul_plain": (lambda ct, ct2, pt, key, diags: ht.mul_plain(ct, pt, CFG),
                  ("aloha.rns.mulmod", "aloha.pack.per_limb")),
    "encode_post": (lambda ct, ct2, pt, key, diags: ht.encode_post(pt, CFG),
                    ("aloha.rns.mulmod_shoup",)),
    "galois": (lambda ct, ct2, pt, key, diags: ht.galois(ct, 3, key[1], CFG),
               ("aloha.pack.ks_pack", "aloha.gather.ntt_domain_aut", "aloha.rns.modred")),
    "rotate": (lambda ct, ct2, pt, key, diags: ht.rotate(ct, 1, key[1], CFG),
               ("aloha.he.galois", "aloha.pack.ks_pack", "aloha.gather.ntt_domain_aut")),
    "conjugate": (lambda ct, ct2, pt, key, diags: ht.conjugate(ct, key[1], CFG),
                  ("aloha.he.galois", "aloha.rns.mulmod")),
    "rotate_hoisted": (lambda ct, ct2, pt, key, diags:
                       ht.rotate_hoisted(ct, [1, 2], [key[1], key[2]], CFG),
                       ("aloha.pack.stacked_keys", "aloha.pack.ks_pack",
                        "aloha.gather.ntt_domain_aut")),
    "rotate_batch": (lambda ct, ct2, pt, key, diags:
                     ht.rotate_batch([ct, ct2], [1, 2], [key[1], key[2]], CFG),
                     ("aloha.pack.stacked_keys", "aloha.pack.batch_stack",
                      "aloha.gather.ntt_domain_aut")),
    "pt_rotate": (lambda ct, ct2, pt, key, diags: ht.pt_rotate(pt, 3, CFG),
                  ("aloha.gather.ntt_domain_aut",)),
    "matvec_bsgs": (lambda ct, ct2, pt, key, diags:
                    ht.matvec_bsgs(ct, diags, [key[1], key[2], key[3]],
                                   [key[4], key[8], key[12]], CFG, g=4),
                    ("aloha.he.rotate_hoisted", "aloha.he.rotate_batch", "aloha.he.mul_plain",
                     "aloha.he.pt_rotate", "aloha.he.hom_add")),
    "ct_mul": (lambda ct, ct2, pt, key, diags: ht.ct_mul(ct, ct2, CFG),
               ("aloha.rns.mulmod", "aloha.rns.addmod", "aloha.pack.per_limb")),
    "relinearize": (lambda ct, ct2, pt, key, diags: ht.relinearize(ct[0], ct[1], ct2[0],
                                                                   key[1], CFG),
                    ("aloha.pack.ks_pack", "aloha.rns.addmod")),
    "rescale": (lambda ct, ct2, pt, key, diags: ht.rescale(ct, CFG),
                ("aloha.pack.rescale", "aloha.pack.scalar_per_limb", "aloha.rns.mulmod")),
}


@pytest.fixture(scope="module")
def operands():
    return _operands()


@pytest.fixture(scope="module")
def recorded(operands):
    """{op: (output, aloha.* events)} of each served op under a profiler,
    recorded once a module after a first call that fills the caches."""
    runs = {}

    def run(op):
        if op not in runs:
            fn = SERVED[op][0]
            fn(*operands)
            runs[op] = _recorded(lambda: fn(*operands))
        return runs[op]

    return run


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("aloha.")]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _flat(x)]


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p.name
        p = p.cpu_parent


def _refuse(*args, **kwargs):
    raise AssertionError("a span opened a profiler range with no profiler recording")


@pytest.mark.parametrize("op", sorted(SERVED))
def test_off_spans_open_no_range_and_change_no_word(op, operands, recorded, monkeypatch):
    """With no profiler, the spans never reach `record_function` or the
    profiler's ops, and the op's words equal those it gives under a profiler."""
    fn = SERVED[op][0]
    on, _ = recorded(op)
    monkeypatch.setattr(profiling, "_enter_range", _refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", _refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = fn(*operands)
    assert all(torch.equal(a, b) for a, b in zip(_flat(off), _flat(on), strict=True))


@pytest.mark.parametrize("op", sorted(SERVED))
def test_each_served_op_is_a_span_with_its_children_inside(op, recorded):
    children = SERVED[op][1]
    _, events = recorded(op)
    outer = [e for e in events if not any(a.startswith("aloha.") for a in _ancestors(e))]
    assert [e.name for e in outer] == [f"aloha.he.{op}"]
    names = {e.name for e in events}
    assert set(children) <= names, sorted(names)
    for e in events:
        if e.name.startswith(CHILDREN):
            assert f"aloha.he.{op}" in _ancestors(e), (e.name, list(_ancestors(e)))
    assert not any(n.startswith("aloha.build.") for n in names)


def test_served_ops_keep_their_names_and_signatures():
    for op in SERVED:
        fn = getattr(ht, op)
        assert fn.__name__ == op and fn.__doc__ == fn.__wrapped__.__doc__
        assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
    assert ks_kernel.prepare_ksk.__name__ == "prepare_ksk"
    assert ntt_torch.tables.cache_info().maxsize == 64  # the cache sits outside the span


#: a cached function, the call that fills it, and its span
CACHED = {
    "tables": (ntt_torch.tables, lambda: ntt_torch.tables(N, CFG.moduli[:1], CFG.psi[:1], CPU)),
    "twiddles_np": (ntt_torch.twiddles_np,
                    lambda: ntt_torch.twiddles_np(N, CFG.psi[1], CFG.moduli[1])),
    "aut_perm": (ntt_torch.aut_perm, lambda: ntt_torch.aut_perm(N, 5, CPU)),
    "aut_maps": (ntt_torch._aut_maps, lambda: ntt_torch._aut_maps(N, 5, CPU)),
    "modulus": (ntt_stream._modulus, lambda: ntt_stream._modulus(CFG.moduli[0], CPU)),
    "ks_consts": (ks_kernel._consts, lambda: ks_kernel._consts(CFG, CPU)),
    "mxu_tables": (ntt_mxu.kernel_tables,
                   lambda: ntt_mxu.kernel_tables(N, CFG.moduli[:1], (pow(CFG.psi[0], 1,
                                                                           CFG.moduli[0]),),
                                                 False, CPU)),
}


@pytest.mark.parametrize("what", sorted(CACHED) + ["prepare_ksk"])
def test_build_span_on_a_miss_only(what):
    if what == "prepare_ksk":
        key = _words(2 * L * (L + 1), N, seed=99)
        fill = lambda: ks_kernel.prepare_ksk(key, CFG, aut_exp=3)  # noqa: E731
    else:
        cached, fill = CACHED[what]
        cached.cache_clear()
    first = [e.name for e in _recorded(fill)[1]]
    again = [e.name for e in _recorded(fill)[1]]
    assert f"aloha.build.{what}" in first
    assert not any(n.startswith("aloha.build.") for n in again)


def test_span_as_a_context_manager(monkeypatch):
    def body():
        with profiling.span("aloha.test.outer"):
            with profiling.span("aloha.test.inner"):
                return torch.ones(4).sum()

    _, events = _recorded(body)
    assert [e.name for e in events] == ["aloha.test.outer", "aloha.test.inner"]
    assert events[1].cpu_parent.name == "aloha.test.outer"
    monkeypatch.setattr(profiling, "_enter_range", _refuse)
    assert body() == 4


#: the wrappers whose `.launches` count launches of a hand kernel
WRAPPERS = (ks_kernel.ks_head, ks_kernel.ks_tail, ntt_stream.transform,
            ntt_stream.transform_with_tables, ntt_pallas.transform, ntt_mxu.transform,
            ntt_mxu.chain, aut.automorphism, rns_kernel.elementwise)


#: spans a request of each of the benchmark's request shapes (L = 2) on the
#: card, by family: each elementwise stage one `aloha.rns.*` span over both
#: limbs with one `aloha.kernel.rns` launch in it, and no per-limb stack
SPANS_A_REQUEST = {
    "matvec16": {"he": 51, "rns": 68, "pack": 9, "gather": 28, "kernel": 74},
    "rotsum": {"he": 36, "rns": 24, "pack": 24, "gather": 12, "kernel": 48},
    "dotprod": {"he": 39, "rns": 37, "pack": 27, "gather": 13, "kernel": 65},
}


def _request(kind: str, dev):
    """matvec16: 16 diagonals at g = 4, a rescale; rotsum: 12 rotations and
    additions; dotprod: ct_mul, relinearize, rotsum, a rescale."""
    ct, ct2, _, key, diags = _operands(dev, batch=4)
    steps = {1 << i: _words(2 * L * (L + 1), N, seed=200 + i, device=dev) for i in range(12)}

    def rotsum(c):
        for step, k in steps.items():
            c = ht.hom_add(c, ht.rotate(c, step, k, CFG), CFG)
        return c

    if kind == "matvec16":
        return lambda: ht.rescale(ht.matvec_bsgs(ct, diags, [key[1], key[2], key[3]],
                                                 [key[4], key[8], key[12]], CFG, g=4), CFG)
    if kind == "rotsum":
        return lambda: rotsum(ct)
    return lambda: ht.rescale(rotsum(ht.relinearize(*ht.ct_mul(ct, ct2, CFG), key[1], CFG)), CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SPANS_A_REQUEST))
def test_kernel_spans_of_a_request_equal_its_launches(kind):
    """One request of each of the benchmark's shapes at n = 256, B = 4 on the
    card: one `aloha.kernel.*` range a launch that the wrappers count, each
    family's spans as counted from the request chain, and no cache built
    again after a first request."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    dev = torch.device("cuda", 0)
    request = _request(kind, dev)
    want = request()
    torch.cuda.synchronize(dev)
    _build.lib()
    before = sum(w.launches for w in WRAPPERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = request()
        torch.cuda.synchronize(dev)
    launches = sum(w.launches for w in WRAPPERS) - before
    # the host's ranges: with the CUDA activity each also has a device-side copy
    names = [e.name for e in prof.events()
             if e.name.startswith("aloha.") and e.device_type == torch.autograd.DeviceType.CPU]
    families = collections.Counter(n.split(".")[1] for n in names)
    assert families == SPANS_A_REQUEST[kind]  # no aloha.build span among them
    assert families["kernel"] == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
