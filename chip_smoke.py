#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero:
  1. device: requires CUDA (there is no CPU fallback); prints the card
     as `nvidia-smi --query-gpu=name,power.limit` gives it;
  2. build: compiles aloha_tpu_torch/csrc/*.cu with nvcc (sm_90a) into
     aloha_tpu_torch/_build/;
  3. kernels: ntt, ks_head, ks_tail, ntt_mxu (q0, q1 and P, both
     directions) and the ntt_mxu chain at N=8192 against their plain
     PyTorch versions on the card (torch.equal), timed with CUDA events;
  4. serve: three encrypted matrix-vector requests, each a batch of 16
     ciphertexts through he_torch.matvec_bsgs (D=16 diagonals, g=4) and
     rescale; decrypts within 0.15 of the cleartext product, ciphertext 0
     of request 0 word-exact against aloha_tpu.he_np, and every kernel
     launched by the requests;
  5. bench: ntt, ntt_mxu and the chain (k=64) at the bench's own shapes
     and inputs against their plain versions (torch.equal); then
     aloha_tpu_torch.bench.run at N=8192, batch 256, the fused chain cut
     to k=64: each form's NTT/s, bit-exact against the ntt_np chain, with
     ntt and both ntt_mxu wrappers launched.
The line before the last is a JSON object of the kernels (launches summed
over the serve and bench paths, and per path); the last line is
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback

SEED = 2024
B, D, G = 16, 16, 4  # ciphertexts per request, diagonals, baby steps
REQUESTS = 3
BENCH = dict(batch=256, chain_k=64)
ENVELOPE = 0.15  # decrypt error bound of examples/encrypted_matvec.py


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    return card


def phase_build():
    from aloha_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}",
          flush=True)


def time_us(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median over `iters` single calls, each bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


def check(results: dict, card: str, kernel: str, label: str, run, run_plain,
          warmup: int = 3, iters: int = 15):
    """Fail unless run() is torch.equal to run_plain(); time both."""
    import torch

    got, want = run(), run_plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if got.numel() else 0
    if not torch.equal(got, want):
        fail(f"{kernel} {label}: kernel differs from plain (max_abs_err={err})")
    k_us = time_us(run, warmup, iters)
    p_us = time_us(run_plain, warmup, iters)
    print(f"kernel {kernel} {label}: equal=True kernel_us={k_us:.1f} "
          f"plain_us={p_us:.1f} on {card}", flush=True)
    results.setdefault(kernel, []).append((label, err, k_us, p_us))


def phase_kernels(card: str, dev):
    import numpy as np
    import torch

    from aloha_tpu.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.ops import ks_kernel as ksk_ops
    from aloha_tpu_torch.ops import ntt_mxu, ntt_stream

    rng = np.random.default_rng(SEED)
    L, n, mod = CFG.n_limbs, CFG.n, CFG.moduli
    results = {}

    def rand(shape, moduli):
        """Canonical residues, modulus moduli[i] along the first axis."""
        return cv.from_u64(
            np.stack([rng.integers(0, q, size=shape, dtype=np.uint64) for q in moduli]),
            dev,
        )

    def case(kernel, label, run, run_plain):
        check(results, card, kernel, label, run, run_plain)

    # ntt: a multi-modulus case (M=3, nb=64), then rescale's shapes (B=16 x 2 parts)
    x3 = rand((64, n), mod)
    case("ntt", "fwd M=3 nb=64",
         lambda: ntt_stream.transform(x3, mod, CFG.psi, False),
         lambda: ntt_stream.transform_plain(x3, mod, CFG.psi, False))
    case("ntt", "inv M=3 nb=64",
         lambda: ntt_stream.transform(x3, mod, CFG.ipsi, True),
         lambda: ntt_stream.transform_plain(x3, mod, CFG.ipsi, True))
    x1 = rand((2 * B, n), mod[L - 1:L])
    case("ntt", f"inv M=1 nb={2 * B} (rescale)",
         lambda: ntt_stream.transform(x1, mod[L - 1:L], CFG.ipsi[L - 1:L], True),
         lambda: ntt_stream.transform_plain(x1, mod[L - 1:L], CFG.ipsi[L - 1:L], True))

    # ks_head: hoisted (the request's baby steps) and with an automorphism
    b = rand((B, n), mod[:L])
    e = pow(3, 5, 2 * n)
    case("ks_head", f"hoisted nb={B}",
         lambda: ksk_ops.ks_head(b, None, CFG),
         lambda: ksk_ops.ks_head_plain(b, None, CFG))
    case("ks_head", f"aut nb={B}",
         lambda: ksk_ops.ks_head(b, e, CFG),
         lambda: ksk_ops.ks_head_plain(b, e, CFG))

    # ks_tail: raised digits from the head, random keys of the KSK layout
    nd = ksk_ops.ks_head(b, None, CFG)
    rider = rand((B, n), mod[:L])
    stride = 2 * L

    def key():
        rows = [rng.integers(0, mod[p // stride], size=n, dtype=np.uint64)
                for p in range(stride * (L + 1))]
        return cv.from_u64(np.stack(rows), dev)

    keys3 = [key() for _ in range(3)]
    prep = [ksk_ops.prepare_ksk(k, CFG, aut_exp=pow(3, s, 2 * n))
            for k, s in zip(keys3, (1, 2, 3))]
    k3 = torch.stack([p[0] for p in prep])
    s3 = torch.stack([p[1] for p in prep])
    case("ks_tail", f"shared K=3 nb={B} (baby steps)",
         lambda: ksk_ops.ks_tail(nd, rider, k3, CFG, kshoup=s3, shared_inputs=True),
         lambda: ksk_ops.ks_tail_plain(nd, rider, k3, CFG, shared_inputs=True))
    nd48 = ksk_ops.ks_head(rand((3 * B, n), mod[:L]), None, CFG)
    rider48 = rand((3 * B, n), mod[:L])
    case("ks_tail", f"batched K=3 nb={3 * B} (giant steps)",
         lambda: ksk_ops.ks_tail(nd48, rider48, k3, CFG, kshoup=s3),
         lambda: ksk_ops.ks_tail_plain(nd48, rider48, k3, CFG))
    case("ks_tail", f"single nb={B} shoup",
         lambda: ksk_ops.ks_tail(nd, rider, prep[0][0], CFG, kshoup=prep[0][1]),
         lambda: ksk_ops.ks_tail_plain(nd, rider, prep[0][0], CFG))
    case("ks_tail", f"single nb={B} barrett",
         lambda: ksk_ops.ks_tail(nd, rider, keys3[0], CFG),
         lambda: ksk_ops.ks_tail_plain(nd, rider, keys3[0], CFG))

    # ntt_mxu: each modulus alone, both directions; then the fused chain
    for m, name in enumerate(("q0", "q1", "P")):
        xm = rand((64, n), mod[m:m + 1])
        for inv, roots in ((False, CFG.psi), (True, CFG.ipsi)):
            label = f"{'inv' if inv else 'fwd'} {name} nb=64"
            case("ntt_mxu", label,
                 lambda: ntt_mxu.transform(xm, mod[m:m + 1], roots[m:m + 1], inv),
                 lambda: ntt_mxu.transform_plain(xm, mod[m:m + 1], roots[m:m + 1], inv))
    for m, name in ((0, "q0"), (2, "P")):
        xc = rand((16, n), mod[m:m + 1])[0]
        for inv, root in ((False, CFG.psi[m]), (True, CFG.ipsi[m])):
            label = f"{'inv' if inv else 'fwd'} {name} k=3 nb=16"
            case("ntt_mxu_chain", label,
                 lambda: ntt_mxu.chain(xc, mod[m], root, 3, inv),
                 lambda: ntt_mxu.chain_plain(xc, mod[m], root, 3, inv))
    return results


def phase_bench(card: str, dev, results: dict):
    import numpy as np

    from aloha_tpu.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch import bench
    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.ops import ntt_mxu, ntt_stream

    # each wrapper at the bench's own shapes and inputs, against its plain version
    n, q, psi = CFG.n, CFG.moduli[0], CFG.psi[0]
    nb, k = BENCH["batch"], BENCH["chain_k"]
    x = cv.from_u64(np.random.default_rng(0).integers(0, q, size=(nb, n), dtype=np.uint64),
                    dev)
    x1 = x[None]
    check(results, card, "ntt", f"fwd q0 (1, {nb}, {n}) bench",
          lambda: ntt_stream.transform(x1, (q,), (psi,), False),
          lambda: ntt_stream.transform_plain(x1, (q,), (psi,), False), 1, 3)
    check(results, card, "ntt_mxu", f"fwd q0 (1, {nb}, {n}) bench",
          lambda: ntt_mxu.transform(x1, (q,), (psi,), False),
          lambda: ntt_mxu.transform_plain(x1, (q,), (psi,), False), 1, 3)
    check(results, card, "ntt_mxu_chain", f"fwd q0 k={k} nb={nb} bench",
          lambda: ntt_mxu.chain(x, q, psi, k, False),
          lambda: ntt_mxu.chain_plain(x, q, psi, k, False), 0, 1)

    # the main path: counts start at 0 here
    counters = {"ntt": ntt_stream.transform, "ntt_mxu": ntt_mxu.transform,
                "ntt_mxu_chain": ntt_mxu.chain}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    records = bench.run(card_line=card, **BENCH)
    launches = {name: fn.launches for name, fn in counters.items()}
    for rec in records:
        print(f"bench {rec['metric']}: {rec['value']:.1f} NTT/s (batch {rec['batch']}, "
              f"chain {rec['chain']}) bitexact={rec['bitexact']} on {rec['card']}",
              flush=True)
    print(f"bench: {time.perf_counter() - t0:.1f} s, launches={launches}", flush=True)
    for rec in records:
        if not rec["bitexact"]:
            fail(f"bench {rec['metric']} is not bit-exact against the ntt_np chain")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched by the bench")
    return launches


def phase_serve(card: str, dev):
    import numpy as np
    import torch

    from aloha_tpu import encoder, he_np, keys
    from aloha_tpu.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import he_torch as ht
    from aloha_tpu_torch.ops import ks_kernel as ksk_ops
    from aloha_tpu_torch.ops import ntt_stream

    n, S = CFG.n, CFG.n // 2
    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    nb_giant = (D + G - 1) // G

    # set-up (host keys, encoded diagonals on the card, client encryption)
    t0 = time.perf_counter()
    sk = keys.gen_secret(CFG, rng=np.random.default_rng(SEED))
    baby_steps = list(range(1, G))
    giant_steps = [G * i for i in range(1, nb_giant)]
    ksk_np = {s: keys.gen_rotation_key(sk, s, CFG, rng=np.random.default_rng(SEED + s))
              for s in baby_steps + giant_steps}
    ksk = {s: cv.ksk_from_np(k, CFG, dev) for s, k in ksk_np.items()}
    for s, k in ksk.items():  # one-time key preparation, as at key load
        ksk_ops.prepare_ksk(k, CFG, aut_exp=pow(3, s, 2 * n))
    rng = np.random.default_rng(SEED + 100)
    dvecs = [rng.uniform(-1, 1, size=S) for _ in range(D)]
    dcoeff = np.stack([encoder.encode(encoder.cleartext_from_slots(d + 0j), CFG)
                       for d in dvecs])
    diags_np = [he_np.encode_post(c, CFG) for c in dcoeff]
    diags = ht.encode_post(cv.from_u64(dcoeff, dev), CFG)
    if not np.array_equal(cv.to_u64(diags), np.stack(diags_np)):
        fail("encode_post of the diagonals differs from he_np.encode_post")
    requests = []
    for r in range(REQUESTS):
        zs, cts = [], []
        for i in range(B):
            z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
            pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
            signed = np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0),
                              pt[0].astype(np.int64))
            cts.append(keys.encrypt(signed, sk, CFG,
                                    rng=np.random.default_rng(SEED + 1000 * r + i)))
            zs.append(z)
        requests.append((zs, np.stack([c.a for c in cts]), np.stack([c.b for c in cts])))
    print(f"serve: set-up {time.perf_counter() - t0:.1f} s (host keygen, encode, "
          f"encryption of {REQUESTS}x{B} ciphertexts)", flush=True)

    # the main path: counts start at 0 here
    counters = {"ntt": ntt_stream.transform, "ks_head": ksk_ops.ks_head,
                "ks_tail": ksk_ops.ks_tail}
    for fn in counters.values():
        fn.launches = 0
    baby = [ksk[s] for s in baby_steps]
    giant = [ksk[s] for s in giant_steps]
    lat, outs = [], []
    for _, A, Bp in requests:
        t = time.perf_counter()
        ct = (cv.from_u64(A, dev), cv.from_u64(Bp, dev))
        out = ht.rescale(ht.matvec_bsgs(ct, list(diags), baby, giant, CFG, g=G), CFG)
        outs.append((cv.to_u64(out[0]), cv.to_u64(out[1])))
        lat.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"serve: {REQUESTS} requests of B={B} ciphertexts (N={n}, L={CFG.n_limbs}, "
          f"D={D}, g={G}): {REQUESTS / sum(lat):.3f} requests/s, latency_s="
          f"{[round(x, 4) for x in lat]}, launches={launches} on {card}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched by the main path")

    # checks: decrypt error, word-exactness against the NumPy oracle
    worst = 0.0
    for (zs, _, _), (oa, ob) in zip(requests, outs):
        if oa.shape != (B, 1, n) or ob.shape != (B, 1, n):
            fail(f"output shape {oa.shape}, expected {(B, 1, n)}")
        for i, z in enumerate(zs):
            m = keys.decrypt(he_np.Ciphertext(a=oa[i], b=ob[i]), sk, CFG)
            res = np.where(m < 0, m + np.int64(q0), m).astype(np.uint64)
            got = encoder.decode(res[None, :], CFG, limb=0) * (q1 / encoder.DELTA)
            want = sum(d * np.roll(z, -k) for k, d in enumerate(dvecs))
            worst = max(worst, float(np.abs(got - want).max()))
    if not worst < ENVELOPE:
        fail(f"decrypt error {worst} >= {ENVELOPE}")
    _, A, Bp = requests[0]
    ref = he_np.rescale(he_np.matvec_bsgs(
        he_np.Ciphertext(a=A[0], b=Bp[0]), diags_np,
        [ksk_np[s] for s in baby_steps], [ksk_np[s] for s in giant_steps], CFG, g=G,
    ), CFG)
    exact = np.array_equal(outs[0][0][0], ref.a) and np.array_equal(outs[0][1][0], ref.b)
    if not exact:
        fail("ciphertext 0 of request 0 differs from he_np.matvec_bsgs + rescale")
    print(f"serve: max decrypt error {worst:.4f} < {ENVELOPE} over {REQUESTS * B} "
          f"ciphertexts; ciphertext 0 word-exact against he_np", flush=True)
    return launches


def main():
    card = phase_device()
    import torch

    try:
        phase_build()
        dev = torch.device("cuda", 0)
        results = phase_kernels(card, dev)
        paths = {"serve": phase_serve(card, dev), "bench": phase_bench(card, dev, results)}
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail("a phase raised")
    from aloha_tpu.config import DEFAULT_CONFIG as CFG

    nb, n, k = BENCH["batch"], CFG.n, BENCH["chain_k"]
    meta = {
        "ntt": ("aloha_tpu_torch/csrc/ntt.cu", "aloha_tpu/ops/ntt_stream.py:721",
                "aloha_tpu/ops/ntt_stream.py:814", f"fwd q0 (1, {nb}, {n}) bench"),
        "ks_head": ("aloha_tpu_torch/csrc/ks.cu", "aloha_tpu/ops/ks_kernel.py:478",
                    None, f"hoisted nb={B}"),
        "ks_tail": ("aloha_tpu_torch/csrc/ks.cu", "aloha_tpu/ops/ks_kernel.py:568",
                    None, f"shared K=3 nb={B} (baby steps)"),
        "ntt_mxu": ("aloha_tpu_torch/csrc/ntt_mxu.cu", "aloha_tpu/ops/ntt_mxu.py:653",
                    None, f"fwd q0 (1, {nb}, {n}) bench"),
        "ntt_mxu_chain": ("aloha_tpu_torch/csrc/ntt_mxu.cu", "aloha_tpu/ops/ntt_mxu.py:860",
                          "aloha_tpu/ops/ntt_mxu.py:742", f"fwd q0 k={k} nb={nb} bench"),
    }
    kernels = []
    for name, (src, repl, also, main_case) in meta.items():
        rows = results[name]
        _, _, k_us, p_us = next(r for r in rows if r[0] == main_case)
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": repl,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": max(r[1] for r in rows),
                 "ms": k_us / 1e3, "plain_ms": p_us / 1e3, "shape": main_case}
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
