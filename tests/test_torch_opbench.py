"""The op bench (`aloha_tpu_torch.opbench`) on the CPU against the JAX package's oracles.

Every row runs through `opbench.run(device="cpu", batch=2, chain_k=2,
trials=1)` with the JAX package's keys carried across by `convert`, and
batch element 0 of its chain is held against the JAX tool's oracle links
(tools/bench_opsuite.py:91-118 and :251-329, chained as that tool chains
them, for the links the row reports):

- hom_add, mul_plain, ct_mul_like, rotate, matvec_step, encode_post,
  rotate_hoisted (all 12 outputs of the last link), matvec_bsgs (D = 16,
  g = 4) and multiply (`he_np.ct_mul` -> `relinearize`) against `he_np`;
- encode against `aloha_tpu.encoder_hw` + `ntt_np` on the same ROM source
  (the JAX package's ROM directory when it exists; never the frozen
  digests of tests/test_encoder_hw.py);
- isa_oplist against the JAX package's `HostRunner` on the same op-list,
  both ciphertexts' DRAM words;
- end_to_end: the last request's output against `he_np.matvec_bsgs` ->
  `rescale` of its encryption, its decryption against `aloha_tpu.keys`;
  the replay of each request's worst vector.

Tolerance: exact words; the end-to-end decryptions within 0.15 of the
cleartext product and within `client.noise_bound` noise standard
deviations.  The material is the JAX tool's inputs (its
np.random.default_rng(0) stream), every row carries its fields, a row that
raises makes main() exit nonzero, and `--device cuda` without a card
raises.
"""

import dataclasses
import functools
import inspect
import json
import os

import numpy as np
import pytest
import torch

from aloha_tpu import encoder as jencoder
from aloha_tpu import encoder_hw as jhw
from aloha_tpu import he_np
from aloha_tpu import keys as jkeys
from aloha_tpu import ntt_np as jntt
from aloha_tpu.config import DEFAULT_CONFIG as JCFG
from aloha_tpu.runtime import device as jdevice
from aloha_tpu.runtime import host as jhost
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import client, encoder_hw, opbench
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

torch.set_num_threads(2)

B, K = 2, 2
CPU = torch.device("cpu")
L, N = CFG.n_limbs, CFG.n
FIELDS = {"unit", "batch", "chain", "recorded", "marginal", "marginal_reliable", "bitexact",
          "bitexact_links", "launches", "device_busy", "card", "graph_recorded",
          "graph_marginal", "seconds", "t_full_ms", "t_half_ms"}
_JAX_ROMS = inspect.signature(jhw.load_combine_roms.__wrapped__).parameters["path"].default


@pytest.fixture(autouse=True, scope="module")
def same_rom_source():
    old = encoder_hw.ROM_DIR
    encoder_hw.ROM_DIR = _JAX_ROMS if os.path.isdir(_JAX_ROMS) else None
    yield
    encoder_hw.ROM_DIR = old


@pytest.fixture(scope="module")
def jkeyset():
    """The JAX package's keys, the JAX tool's seeds: sk rng(1), step s
    rng(10 + s); the relinearization key rng(50)."""
    sk = jkeys.gen_secret(JCFG, np.random.default_rng(1))
    rot = {s: jkeys.gen_rotation_key(sk, s, JCFG, np.random.default_rng(10 + s))
           for s in opbench.key_steps()}
    return sk, rot, jkeys.gen_relin_key(sk, JCFG, np.random.default_rng(50))


@pytest.fixture(scope="module")
def keyset(jkeyset):
    sk, rot, rlk = jkeyset
    return {"sk": cv.sk_from_np(sk, CPU),
            "rot": {s: cv.ksk_from_np(k, CFG, CPU) for s, k in rot.items()},
            "rlk": cv.ksk_from_np(rlk, CFG, CPU)}


@pytest.fixture(scope="module")
def mat(keyset):
    return opbench.material(CFG, CPU, B, keyset=keyset)


def _run(name, keyset):
    outputs = {}
    res = opbench.run(CFG, "cpu", B, K, [name], trials=1, keyset=keyset, outputs=outputs)
    row = res["rows"][name]
    assert "error" not in row, row
    assert FIELDS <= set(row), FIELDS - set(row)
    assert row["batch"] == (min(B, opbench.ISA_BATCH) if name == "isa_oplist" else B)
    assert row["chain"] >= opbench.links(name, K) and row["recorded"] > 0
    assert row["bitexact"] is None or name == "end_to_end"  # no replay on the CPU
    assert row["card"] == "cpu" and row["graph_recorded"] is None
    assert opbench.failures(res) == []
    json.dumps(res)
    return row, outputs[name]


def _np_ct(ct, i=0):
    return he_np.Ciphertext(a=cv.to_u64(ct[0])[i], b=cv.to_u64(ct[1])[i])


def _same(got, want: he_np.Ciphertext):
    """got: the bench's (a, b) uint64 arrays of batch element 0."""
    assert np.array_equal(got[0][0], want.a) and np.array_equal(got[1][0], want.b)


def test_material_is_the_jax_tools_inputs(mat):
    """The uniform words are tools/bench_opsuite.py's, drawn in its order:
    a1, b1, a2, b2, pt, the epoch sample, the D diagonals."""
    rng = np.random.default_rng(0)
    lim = np.broadcast_to(np.asarray(JCFG.moduli[:L], dtype=np.uint64)[:, None], (L, N))

    def rand_u64(shape):
        return rng.integers(0, 1 << 63, size=shape + (L, N), dtype=np.uint64) % lim

    a1, b1, a2, b2, ptv = (rand_u64((B,)) for _ in range(5))
    rand_u64((B,))
    diags = [rand_u64(()) for _ in range(opbench.MATVEC_D)]
    for got, want in ((mat.ct1[0], a1), (mat.ct1[1], b1), (mat.ct2[0], a2),
                      (mat.ct2[1], b2), (mat.pt, ptv)):
        assert np.array_equal(cv.to_u64(got), want)
    assert all(np.array_equal(cv.to_u64(g), w) for g, w in zip(mat.diags, diags))
    assert np.array_equal(mat.isa_flat, np.concatenate([a1.reshape(B, -1), b1.reshape(B, -1)],
                                                       axis=1))


def _oracles(mat, jkeyset):
    """The JAX tool's oracle links on batch element 0."""
    _, rot, rlk = jkeyset
    ct2, pt = _np_ct(mat.ct2), cv.to_u64(mat.pt)[0]
    steps = list(range(1, opbench.HOISTED_K + 1))
    diags = [cv.to_u64(d) for d in mat.diags]
    G = opbench.MATVEC_G
    baby = [rot[j] for j in range(1, G)]
    giant = [rot[G * i] for i in range(1, -(-opbench.MATVEC_D // G))]
    return {
        "hom_add": lambda c: he_np.hom_add(c, ct2, JCFG),
        "mul_plain": lambda c: he_np.mul_plain(c, pt, JCFG),
        "ct_mul_like": lambda c: he_np.hom_add(he_np.mul_plain(c, pt, JCFG),
                                               he_np.mul_plain(ct2, pt, JCFG), JCFG),
        "rotate": lambda c: he_np.rotate(c, 2, rot[2], JCFG),
        "matvec_step": lambda c: he_np.hom_add(
            he_np.mul_plain(he_np.rotate(c, 2, rot[2], JCFG), pt, JCFG), ct2, JCFG),
        "encode_post": lambda c: he_np.Ciphertext(a=he_np.encode_post(c.a, JCFG), b=c.b),
        "rotate_hoisted": lambda c: he_np.rotate_hoisted(
            c[0], steps, [rot[s] for s in steps], JCFG),
        "matvec_bsgs": lambda c: he_np.matvec_bsgs(c, diags, baby, giant, JCFG, g=G),
        "multiply": lambda c: he_np.relinearize(*he_np.ct_mul(c, ct2, JCFG), rlk, JCFG),
    }


@pytest.mark.parametrize("name", [r for r in opbench.GRAPH_ROWS if r != "encode"])
def test_ciphertext_rows_word_for_word(name, keyset, mat, jkeyset):
    row, got = _run(name, keyset)
    link = _oracles(mat, jkeyset)[name]
    c = [_np_ct(mat.ct1)] if name == "rotate_hoisted" else _np_ct(mat.ct1)
    for _ in range(row["chain"]):
        c = link(c)
    if name == "rotate_hoisted":
        assert len(got) == len(c) == opbench.HOISTED_K
        for g, w in zip(got, c):
            _same(g, w)
        assert row["unit"] == "rotations/s/card"
    else:
        _same(got, c)
    assert row["launches"] == {}  # the plain path launches no kernel


def test_encode_row_against_encoder_hw(keyset, mat):
    row, got = _run("encode", keyset)
    j = row["chain"] - 1  # the last link encodes cleartext batch j mod 2
    coeff = jhw.encode(mat.clear[j % 2][0].numpy(), JCFG)
    want = np.stack([jntt.ntt(coeff[m], JCFG.moduli[m], JCFG.psi[m]) for m in range(L)])
    assert np.array_equal(got[0], want)
    first = cv.to_u64(opbench.LINKS["encode"](mat, None, 0))  # and link 0's batch, both elements
    for i in range(B):
        coeff = jhw.encode(mat.clear[0][i].numpy(), JCFG)
        want = np.stack([jntt.ntt(coeff[m], JCFG.moduli[m], JCFG.psi[m]) for m in range(L)])
        assert np.array_equal(first[i], want)


def test_isa_oplist_against_the_jax_host_runner(keyset, mat, jkeyset):
    row, got = _run("isa_oplist", keyset)
    k, nb = row["chain"], row["batch"]
    _, rot, _ = jkeyset
    words = max(1 << 23, jhost.DRAM_VP_BASE // 8 + 2 * nb * 4 * N)
    runner = jhost.HostRunner(jdevice.AlohaDevice(JCFG), JCFG, dram_words=words,
                              encoder=functools.partial(jencoder.encode, cfg=JCFG))
    for c in (2, 4):
        runner.dev.dma_load_ksk(rot[c], row=runner.dev.rotation_ksk_ptr(c))
    runner.load_dram(jhost.DRAM_ENCODER_BASE, mat.isa_clear.view(np.uint64))
    runner.load_dram(jhost.DRAM_VP_BASE, mat.isa_flat)
    for j in range(k):
        runner.run(opbench.isa_oplist(CFG, nb, j))
    base = jhost.DRAM_VP_BASE + (k % 2) * nb * 4 * N * 8
    want = runner.read_dram(base, nb * 4 * N).reshape(nb, -1)
    assert got.shape == want.shape == (nb, 4 * N)
    assert np.array_equal(got, want)
    assert row["ops"] == 1 + 6 * nb * k and row["ops_per_s"] > 0


def test_end_to_end_against_he_np(keyset, mat, jkeyset):
    row, (ct, out, dec) = _run("end_to_end", keyset)
    assert row["decrypt_error"] < opbench.ENVELOPE == 0.15 and row["within_envelope"]
    assert row["bitexact"] is None and row["bitexact_links"] == 0  # no replay on the CPU
    assert row["noise_ratio"] < row["noise_bound"] and row["within_noise_bound"]
    assert row["noise_bound"] == client.noise_bound(row["chain"] * B * N // 2)
    sk, rot, _ = jkeyset
    G = opbench.MATVEC_G
    ddiags = [cv.to_u64(d) for d in mat.ddiags]
    baby = [rot[j] for j in range(1, G)]
    giant = [rot[G * i] for i in range(1, -(-opbench.MATVEC_D // G))]
    j = row["chain"] - 1
    worst = 0.0
    for i in range(B):
        c = he_np.Ciphertext(a=ct[0][i], b=ct[1][i])
        want = he_np.rescale(he_np.matvec_bsgs(c, ddiags, baby, giant, JCFG, g=G), JCFG)
        assert np.array_equal(out[0][i], want.a) and np.array_equal(out[1][i], want.b)
        m = jkeys.decrypt(want, sk, JCFG)
        assert np.array_equal(m, dec[i])
        res = np.where(m < 0, m + np.int64(JCFG.moduli[0]), m).astype(np.uint64)
        got = jencoder.decode(res[None, :], JCFG, limb=0) * (JCFG.moduli[1] / jencoder.DELTA)
        clear = sum(v * np.roll(mat.zs[j % 2][i], -d) for d, v in enumerate(mat.dvecs))
        worst = max(worst, float(np.abs(got - clear).max()))
    assert worst < 0.15
    assert row["decrypt_error"] >= worst
    if row["decrypt_error_at"][0] == j:
        assert row["decrypt_error"] == pytest.approx(worst, rel=1e-12)


def test_end_to_end_replays_each_requests_worst_vector(mat):
    """With a plain-path material the row replays every request's vector
    of largest error, worst first; other diagonals there make it differ."""
    m0 = mat.element0(CPU)
    res = opbench._replay_e2e(mat, m0, 2, budget_s=1e9)
    assert res["bitexact"] is True and res["bitexact_links"] == 2
    j, i = res["decrypt_error_at"]
    _, _, dec = opbench._request(mat, j)
    err, ratio, _ = opbench._errors(mat, j, dec)
    assert res["decrypt_error"] == err.max() == err[i]
    assert ratio <= res["noise_ratio"] < res["noise_bound"] == client.noise_bound(2 * B * N // 2)
    assert 0.85 < res["noise_mean_square"] < 1.2
    bad = opbench._replay_e2e(mat, dataclasses.replace(m0, ddiags=m0.ddiags[::-1]), 2, 1e9)
    assert bad["bitexact"] is False and bad["bitexact_links"] == 1


def test_chain_lengths():
    assert [opbench.links(r, 16) for r in opbench.ROWS] == [128, 128, 64, 16, 16, 64, 16, 16,
                                                            16, 64, 2, 4]
    assert min(opbench.links(r, 1) for r in opbench.ROWS) == 2
    assert opbench.links("matvec_bsgs", 2) == 4


def test_forced_error_row_exits_nonzero(monkeypatch, capsys, keyset):
    real = opbench.material
    monkeypatch.setattr(opbench, "material",
                        lambda cfg, dev, batch, keyset=None: real(cfg, dev, batch, keyset=ks))
    ks = keyset

    def boom(m, s, j):
        raise RuntimeError("forced")

    monkeypatch.setitem(opbench.LINKS, "hom_add", boom)
    argv = ["--device", "cpu", "--batch", "1", "--chain", "2", "--trials", "1", "--ops"]
    assert opbench.main(argv + ["hom_add,mul_plain"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["row"] == "hom_add" and lines[0]["error"] == "RuntimeError: forced"
    assert lines[1]["row"] == "mul_plain" and "error" not in lines[1]
    assert lines[-1]["failed"] == ["hom_add"]
    assert opbench.main(argv + ["mul_plain"]) == 0


@pytest.mark.parametrize("bad", [{"bitexact": False}, {"graph_bitexact": False},
                                 {"plain_graph_bitexact": False}, {"error": "x"},
                                 {"within_noise_bound": False}])
def test_failures_name_the_rows_at_fault(bad):
    good = {"bitexact": True, "graph_bitexact": True, "decrypt_error": 0.2,
            "within_envelope": False, "within_noise_bound": True}
    res = {"rows": {"a": dict(good), "b": {**good, **bad}, "c": {"bitexact": None}}}
    assert opbench.failures(res) == ["b"]


def test_unknown_rows_and_cuda_without_a_card_raise():
    with pytest.raises(ValueError, match="unknown rows"):
        opbench.run(CFG, "cpu", 1, 2, ["hom_add", "nope"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="GPU"):
        opbench.run(CFG, "cuda", 1, 2, ["hom_add"])
    assert opbench.main(["--ops", "hom_add"]) == 1
