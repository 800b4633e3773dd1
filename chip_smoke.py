#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero:
  1. device: requires CUDA (there is no CPU fallback); prints the card
     as `nvidia-smi --query-gpu=name,power.limit` gives it;
  2. build: compiles aloha_tpu_torch/csrc/*.cu with nvcc (sm_90a, one nvcc
     per source, all at once) into aloha_tpu_torch/_build/; the SASS
     (cuobjdump) of the rate kernel and of the tensor-core transform holds
     IGMMA and no IMMA; ptxas' registers and spill of each instance of
     csrc/ntt.cu's register-pass transform (45: one CTA a polynomial, and
     clusters of 2 and 4 CTAs) and of csrc/ks.cu's two kernels (one CTA a
     polynomial at n = 1-8192; ks_tail also a cluster of 4 at 8192); the
     lane kernel's and csrc/probe_ops.cu's 15 variants' registers, no
     spill, and in the SASS of probe_ops shared-memory accesses and
     barriers in v6 alone; the SASS of the parts probe's full and mxu
     instances holds IGMMA and no IMMA or HMMA, vpu's none, and their
     registers and spill; the registers and spill of the stage-modes
     kernel's three instances beside ntt.cu's forward transform at n = 8192
     (ntt_regs_kernel<13, false, 1>), whose register passes they run; the
     registers and spill of the copy pipeline's 8 stages instances
     (stages_ring<0..7>) beside rows 17 and 19's two_slots, failing unless
     ptxas reports 8;
  3. kernels: ntt, ks_head, ks_tail, ntt_mxu (q0, q1 and P, both
     directions) and the ntt_mxu chain at N=8192 against their plain
     PyTorch versions on the card (torch.equal), timed with CUDA events;
     each ks case (the head hoisted at nb = 16 and 48 and with an
     automorphism, the tail over shared, batched and single keys) also in
     a CUDA-graph burst, and a tail that takes a cluster beside the same
     launch forced onto one CTA a polynomial (equal words);
     then ntt at n = 2, 16, 128, 1024, 2048, 4096, 8192 and 16384, both
     directions, M = 1 and 3, nb = 1, 131, 132, 133 and 264, on words at
     the top of its input window (compared); ntt_mxu and its chain (k = 1,
     2, 3) at N = 4096 and 8192, both
     directions, nb = 1, 131, 132, 133 and 264, on words at the ends of
     the fold's range (0, q - 1, 2^63 - 1) and random ones (compared);
  4. serve: three encrypted matrix-vector requests, each a batch of 16
     ciphertexts through he_torch.matvec_bsgs (D=16 diagonals, g=4) and
     rescale, with keys, encodings and encryptions made by the port
     (aloha_tpu_torch.keys and .encoder); decrypts within 0.15 of the
     cleartext product, ciphertext 0 of request 0 word-exact against the
     port's plain path on CPU tensors, and every kernel launched by the
     requests;
  5. bench: ntt, ntt_grid, ntt_mxu and the chain (k=64) at the bench's
     own shapes and inputs against their plain versions (torch.equal); the
     ntt kernel's marginal ns per polynomial over the batch (nb = 256 ->
     1024), both directions, beside the bound of one transform, and its
     ISA shape (M = 1, nb = 1) eager and in a CUDA-graph burst, also at
     one CTA a polynomial (C = 1 forced), and beside the forward marginal
     the stage-modes probe's full marginal (the same transform, chained in
     one launch) with their ratio; the
     chain's marginal ns per polynomial per transform at nb = 256 (k = 1
     against k = 9) beside its bound, and on the same line the parts
     probe's full marginal (the same kernel code, folded every transform);
     then aloha_tpu_torch.bench.run at
     N=8192, batch 256, the fused chain cut to k=64: each form's NTT/s,
     bit-exact against the ntt_np chain, with ntt, ntt_grid and both
     ntt_mxu wrappers launched;
  6. shard: ntt_stream.transform_with_tables (the NTT kernel fed a shard's
     tables) for D in {1, 2, 4, 8}, shards 0 and D-1, both directions, at
     N=8192, nb=64, q0, against its plain version; then
     parallel.ntt_sharded / intt_sharded at N=8192 through a real NCCL
     process group of D ranks, D the largest power of two <= the visible
     GPUs (one card: D=1, a world of one): forward equal to ntt_np.ntt on
     the first two polynomials, round trip exact, the kernel launched;
  7. multiply: ntt_grid (the grid NTT's wrapper, ops/ntt_pallas, on
     csrc/ntt.cu at one modulus) forward and inverse under q0, q1 and P at
     N=8192, nb=64 (one row at the top of the input window), at nb=16 (the
     encode shape) and at n=128 and 1024, each against its plain version
     and beside ntt_stream at the same shapes; the wrapper's time under q0
     at N=8192, nb = 1, 16, 32, 48, 64, 256 and 264, both directions, eager
     and in a CUDA-graph burst, beside the same launch forced to C = 1
     (equal words); then 3 batches of B=16 cleartext pairs: he_torch.encode
     on the card (the fixed-point encoder, one ntt_grid launch per limb),
     encryption with the port's keys, ct_mul -> relinearize -> rescale,
     and a rotation by one step both per transform (8 ntt_grid launches)
     and fused (ks_head/ks_tail).  Encodings word-exact against the NumPy
     encoder_hw + ntt_np, the relinearized product within 1e-4 of z1 z2
     (CRT over both limbs at Delta^2), the rescaled one within 0.15, the
     two rotations equal, ciphertext 0 word-exact against the port's plain
     path on CPU tensors, and ntt_grid, ntt, ks_head, ks_tail launched;
  8. isa: aut (csrc/aut.cu) under q0, q1 and P at N=8192, nb=1, 64 and 133
     and nb=16 at row stride 2n (a view of every other row, as the multiply
     path hands it in), and at n = 128 and 1024, nb = 1, for the 12
     rotation exponents 3^(2^k) and 2n-1 (one row of 0 and q), against its
     plain version; then the HE vector-ISA replay: an AlohaDevice with
     the full SPM and KSK memory on the card, rotation keys for 1, 2, 4, 8,
     and a HostRunner op-list in the reference's case3 format (encode, then
     per ciphertext of B=16 load, mul_plain, rotate by 2 and by 4, hom_add,
     store) plus run_rotate(2) and run_rotate_any(5) of the fresh
     encryptions.  Every stored ciphertext word-exact against he_torch on
     the card, ciphertext 0 against the replay on CPU tensors, a key-switch
     .tdb trace verified against the CPU, the rotations decrypting within
     1e-4, the checkpoint round trip exact, ntt and aut launched; host ms
     per launch kind, and one profiled key-switch beside the fused rotate;
     aut's main case (q0, nb = 1, e = 9) and its nb = 16 at stride 2n and
     nb = 64 cases also in a CUDA-graph burst;
  9. probes: the eight cost probes (aloha_tpu_torch.probes; csrc/
     probe_ops.cu, csrc/probe_stages.cu, csrc/probe_mxu.cu, csrc/
     probe_dyn.cu), each kernel in every variant or mode (op_probe v0-v14,
     the forward transforms, stream_prof's three modes, stream_prof2's four
     modes at 2 and 13 stages, the int8 rate probe on wgmma, the three
     parts of a tensor-core transform, the lane and row stages under a
     runtime index) against its plain version (torch.equal) at the main
     path's shape, nb (or BP) = 256, and its lower REPS, the rate probe
     also at BP = 1, 2, 3 and 133 with 0, 1 and 3 repetitions, then at
     nb=8, 3 repetitions (timed; the rate probe at BP=256, 1 repetition
     with w laid out once, eager and in a CUDA-graph burst, beside one
     torch._int_mm of the same products timed both ways; the lane probe's
     full-13 and probe_ops' v0 also in a graph burst), the lane probe in
     every mode on an edge sweep (nb = 1, 3, 133; 0, 1, 7, 14 and 26
     stages; 0 and 3 repetitions), probe_ops in every variant on one (nb =
     1, 3, 133 and 264, past one wave at two CTAs an SM; 0-3 repetitions),
     the parts probe in every variant on one (nb = 1, 131, 132, 133 and
     264, past one wave at one CTA an SM; 0-3 repetitions; polynomials of
     0, q - 1 and 2^63 - 1 beside random ones), the forward transforms and
     the stage modes on one (nb = 1, 3, 133 and 264, 0-3 repetitions, and
     nb = 3 on the edge words 0, q - 1, 2q and 4q - 1);
     then the
     probes' own measurement at nb=256: the marginal ns per polynomial
     (block) per repetition of each, beside its bound (int8 MACs over the
     tensor-core peak, INT32 instructions over the integer issue peak, the
     larger; the stage modes' count is the work the function needs,
     NEEDED_OPS, beside the frozen OPS), with all eight kernels launched.
     Then the four copy pipelines (csrc/probe_dma.cu:
     dma_bisect's one slot in both modes, the double-buffered roll and
     row-pair swap, the table read, 0-7 NTT lane stages) against their
     plain versions at the scripts' batches (16 or 32), at nb=133 and at
     the timed lower nb (2048 blocks, 1024 polynomials; timed there;
     dma_copy also at nb = 1, 131 and 132, and timed eager and in a graph
     burst; the stages at every count on nb = 1, 32, 133 and 264 and on
     the edge words 0, q - 1, 2q, 4q - 1, timed at 0, 4 and 7), and torch
     copy_ of the same blocks both ways; on the main
     path, the host/device split of dma_copy's and copy_'s fixed cost
     (eager and graph at 2048 and 8192 blocks), the marginal ns per
     block (polynomial) over the batch between 2048 and 8192 blocks (1024
     and 4096 polynomials), beside its bound (bytes in and out over the HBM
     rate; the stages' INT32 instructions, the larger), the rate in GB/s,
     and copy_'s marginal (the stages' also per polynomial, two blocks,
     as their floor), with all four kernels launched.
Then the order of redesign ("step 2 order": each kernel's launches x (time
- bound), rows redesigned so far marked).  The line before the last is a
JSON object of the kernels (launches summed over the main paths, and per
path; each kernel's bound from this run's shapes); the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
import traceback

SEED = 2024
B, D, G = 16, 16, 4  # ciphertexts per request, diagonals, baby steps
REQUESTS = 3
BENCH = dict(batch=256, chain_k=64)
SHARD_NB = 64  # polynomials of the shard phase
SHARD_DS = (1, 2, 4, 8)  # shard counts whose tables the kernel is held on
SHARD_TIMEOUT_S = 300  # the spawned sharded ranks, when there are several cards
MUL_BATCHES = 3  # batches of B cleartext pairs on the multiply path
GRID_NB = 64  # polynomials of the grid-kernel cases
RELIN_ENVELOPE = 1e-4  # decrypt error of the relinearized product (tests/test_keys.py)
ENVELOPE = 0.15  # decrypt error bound of examples/encrypted_matvec.py
LANE_EDGE_NBS = (1, 3, 133)  # batches of the lane kernel's edge sweep
LANE_EDGE_NSTAGES = (0, 1, 7, 14, 26)  # its stage counts: s mod 7 and s mod 13 apart
#: batches of probe_ops' edge sweep: 1, 3, more CTAs than SMs, past one
#: wave at two CTAs an SM; each at 0-3 repetitions
OPS_EDGE_NBS = (1, 3, 133, 264)
OPS_EDGE_REPS = (0, 1, 2, 3)
#: (BP, reps) the wgmma rate kernel is held at: one 64-row tile, a whole
#: 128-row tile, a whole and a half tile, 133 tiles (more CTAs than SMs)
RATE_SHAPES = [(bp, r) for bp in (1, 2, 3, 133) for r in (0, 1, 3)]


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
    for kernel, what in (("mxu_rate_kernel", "the rate kernel"),
                         ("ntt_mxu_kernel", "the tensor-core transform")):
        sass = _build.sass_counts(kernel, ("IGMMA", "IMMA"))
        print(f"build: SASS of {what}: {sass['IGMMA']} IGMMA, {sass['IMMA']} IMMA", flush=True)
        if not sass["IGMMA"] or sass["IMMA"]:
            fail(f"{what} is not on integer warpgroup products alone: {sass}")
    registers = ntt_registers()
    return (registers, ks_registers(), lane_registers(), ops_registers(), parts_registers(),
            stage_registers(registers), dma_registers())


#: template instances of csrc/ntt.cu's ntt_regs_kernel<LOGN, INV, C>: both
#: directions of n = 2^0..2^14 at C = 1, and the clusters C = 2, 4 with
#: n/16/C >= 32 threads a CTA, forward from n = 1024 (1024: C = 2;
#: 2048-16384: 2, 4) and inverse from n = 4096 (2, 4)
NTT_INSTANCES = 2 * 15 + (1 + 4 * 2) + 3 * 2


def ntt_registers() -> dict:
    """{"fwd n=2^L C=c" or "inv n=2^L C=c": [registers, spill store bytes,
    spill load bytes]} of csrc/ntt.cu's register-pass transform, one entry
    per template instance, from ptxas' report of the build."""
    import re

    from aloha_tpu_torch import _build

    usage = {}
    for name, use in _build.ptxas_usage("ntt_regs_kernel").items():
        logn, inv, c = re.search(r"ntt_regs_kernelILi(\d+)ELb([01])ELi(\d+)E", name).groups()
        usage[f"{'inv' if inv == '1' else 'fwd'} n=2^{logn} C={c}"] = list(use)
    if len(usage) != NTT_INSTANCES:
        fail(f"ptxas reported {len(usage)} instances of ntt_regs_kernel, not {NTT_INSTANCES}: "
             f"{usage}")
    print("build: ntt_regs_kernel registers/spill stores/spill loads: "
          + ", ".join(f"{k} {'/'.join(map(str, v))}" for k, v in sorted(usage.items())), flush=True)
    return usage


#: template instances of csrc/ks.cu's kernels: ks_head<LOGN> at n =
#: 2^0..2^13 (one CTA a polynomial), ks_tail<LOGN, C> there at C = 1 and a
#: cluster of 4 CTAs at n = 8192
KS_INSTANCES = 14 + (14 + 1)


def ks_registers() -> dict:
    """{"head n=2^L C=c" or "tail ...": [registers, spill store bytes,
    spill load bytes]} of csrc/ks.cu's kernels from ptxas' report."""
    import re

    from aloha_tpu_torch import _build

    usage = {}
    for name, use in _build.ptxas_usage("_kernelILi").items():
        m = re.search(r"ks_(head|tail)_kernelILi(\d+)E(?:Li(\d+)E)?E", name)
        if m:
            usage[f"{m.group(1)} n=2^{m.group(2)} C={m.group(3) or 1}"] = list(use)
    if len(usage) != KS_INSTANCES:
        fail(f"ptxas reported {len(usage)} instances of ks_head/ks_tail_kernel, not "
             f"{KS_INSTANCES}: {usage}")
    print("build: ks_head/ks_tail_kernel registers/spill stores/spill loads: "
          + ", ".join(f"{k} {'/'.join(map(str, v))}" for k, v in sorted(usage.items())), flush=True)
    return usage


def lane_registers() -> dict:
    """{mode: [registers, spill store bytes, spill load bytes]} of
    csrc/probe_stages.cu's lane_stages_kernel<mode>, from ptxas' report;
    fails on a spill (the design holds a group in registers)."""
    import re

    from aloha_tpu_torch import _build
    from aloha_tpu_torch.probes import stream_prof2

    usage = {}
    for name, use in _build.ptxas_usage("lane_stages_kernel").items():
        mode = re.search(r"lane_stages_kernelILi(\d)E", name)
        usage[stream_prof2.MODES[int(mode.group(1))]] = list(use)
    print("build: lane_stages_kernel registers/spill stores/spill loads: "
          + ", ".join(f"{m} {'/'.join(map(str, v))}" for m, v in usage.items()), flush=True)
    if sorted(usage) != sorted(stream_prof2.MODES) or any(v[1] or v[2] for v in usage.values()):
        fail(f"lane_stages_kernel: one instance a mode and no spill expected, ptxas: {usage}")
    return usage


def stage_registers(ntt_usage: dict) -> dict:
    """{mode: [registers, spill store bytes, spill load bytes]} of
    csrc/probe_stages.cu's stage_modes_kernel<mode>, from ptxas' report,
    printed beside ntt.cu's forward transform at n = 8192 (one CTA a
    polynomial), whose passes full runs; a spill is reported, not failed."""
    import re

    from aloha_tpu_torch import _build
    from aloha_tpu_torch.probes import stream_prof

    usage = {}
    for name, use in _build.ptxas_usage("stage_modes_kernel").items():
        mode = re.search(r"stage_modes_kernelILi(\d)E", name)
        usage[stream_prof.MODES[int(mode.group(1))]] = list(use)
    if sorted(usage) != sorted(stream_prof.MODES):
        fail(f"stage_modes_kernel: one instance a mode expected, ptxas: {usage}")
    ntt = ntt_usage["fwd n=2^13 C=1"]
    print("build: stage_modes_kernel registers/spill stores/spill loads: "
          + ", ".join(f"{m} {'/'.join(map(str, usage[m]))}" for m in stream_prof.MODES)
          + f"; beside ntt_regs_kernel<13, false, 1> {'/'.join(map(str, ntt))}", flush=True)
    return usage


def dma_registers() -> dict:
    """{"nstages=k": [registers, spill store bytes, spill load bytes]} of
    csrc/probe_dma.cu's stages_ring<k>, k = 0-7, from ptxas' report,
    printed beside the two-slot pipelines of rows 17 and 19; fails unless
    ptxas reports the 8 instances (a spill is reported, not failed)."""
    import re

    from aloha_tpu_torch import _build
    from aloha_tpu_torch.probes import dma_bisect_stages

    usage = {}
    for name, use in _build.ptxas_usage("stages_ring").items():
        k = re.search(r"stages_ringILi(\d)E", name)
        usage[f"nstages={k.group(1)}"] = list(use)
    usage = dict(sorted(usage.items()))
    if len(usage) != dma_bisect_stages.MAX_STAGES + 1:
        fail(f"ptxas reported {len(usage)} instances of stages_ring, not "
             f"{dma_bisect_stages.MAX_STAGES + 1}: {usage}")
    slots = {step: list(use) for name, use in _build.ptxas_usage("two_slots").items()
             for step in ("RollSwapStep", "TableStep") if step in name}
    print("build: stages_ring registers/spill stores/spill loads: "
          + ", ".join(f"{k} {'/'.join(map(str, v))}" for k, v in usage.items())
          + "; beside two_slots " + ", ".join(f"{k} {'/'.join(map(str, v))}"
                                              for k, v in slots.items()), flush=True)
    return usage


#: SASS opcodes counted in csrc/probe_ops.cu's kernels: products, selects,
#: shared-memory stores and loads, barriers
OPS_SASS = ("IMAD", "SEL", "STS", "LDS", "BAR")


def ops_registers() -> dict:
    """{variant: [registers, spill store bytes, spill load bytes]} of
    csrc/probe_ops.cu's probe_ops_kernel<V>, from ptxas' report; fails on
    a spill (the design holds a polynomial in registers) and unless v6
    alone holds shared-memory accesses and barriers in its SASS."""
    import re

    from aloha_tpu_torch import _build
    from aloha_tpu_torch.probes import op_probe

    usage = {}
    for name, use in _build.ptxas_usage("probe_ops_kernel").items():
        v = int(re.search(r"probe_ops_kernelILi(\d+)E", name).group(1))
        usage[op_probe.VARIANTS[v]] = list(use)
    usage = dict(sorted(usage.items(), key=lambda kv: int(kv[0][1:])))
    print("build: probe_ops_kernel registers/spill stores/spill loads: "
          + ", ".join(f"{v} {'/'.join(map(str, u))}" for v, u in usage.items()), flush=True)
    if sorted(usage) != sorted(op_probe.VARIANTS) or any(u[1] or u[2] for u in usage.values()):
        fail(f"probe_ops_kernel: one instance a variant and no spill expected, ptxas: {usage}")
    counts = {v: _build.sass_counts(f"probe_ops_kernelILi{v[1:]}E", OPS_SASS) for v in usage}
    print("build: probe_ops_kernel SASS " + "/".join(OPS_SASS) + ": "
          + ", ".join(f"{v} {'/'.join(str(c[o]) for o in OPS_SASS)}" for v, c in counts.items()),
          flush=True)
    for v, c in counts.items():
        shared = [c["STS"], c["LDS"], c["BAR"]]
        if (v == "v6") != all(shared) or (v != "v6" and any(shared)):
            fail(f"probe_ops_kernel {v}: shared memory and barriers belong to v6 alone, "
                 f"SASS {c}")
    return usage


def parts_registers() -> dict:
    """{variant: [registers, spill store bytes, spill load bytes]} of
    csrc/probe_mxu.cu's mxu_parts_kernel<V>, from ptxas' report; fails
    unless the SASS of full and mxu holds IGMMA and no IMMA or HMMA and
    vpu's none of them (the products are the transform's wgmma)."""
    from aloha_tpu_torch import _build
    from aloha_tpu_torch.probes import probe_mxu_parts as P

    usage, sass = {}, {}
    for v in P.VARIANTS:
        found = list(_build.ptxas_usage(P.kernel_name(v)).values())
        if len(found) != 1:
            fail(f"ptxas reported {len(found)} instances of {P.kernel_name(v)}, not 1")
        usage[v] = list(found[0])
        sass[v] = _build.sass_counts(P.kernel_name(v), P.SASS_OPS)
    print("build: mxu_parts_kernel registers/spill stores/spill loads, SASS "
          + "/".join(P.SASS_OPS) + ": "
          + ", ".join(f"{v} {'/'.join(map(str, usage[v]))} "
                      f"{'/'.join(str(sass[v][o]) for o in P.SASS_OPS)}" for v in P.VARIANTS),
          flush=True)
    for v, c in sass.items():
        if bool(c["IGMMA"]) != (v != "vpu") or c["IMMA"] or c["HMMA"]:
            fail(f"mxu_parts_kernel {v}: IGMMA in full and mxu alone, no IMMA or HMMA, SASS {c}")
    return usage


def time_us(fn, warmup: int = 3, iters: int = 15) -> float:
    """Mean time of one call over a run of `iters` calls launched back to
    back between two CUDA events, after `warmup` calls.  A single call
    between two events would also count the host's enqueue time, which is
    longer than the device time of the small launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) * 1e3 / iters


# ---------------------------------------------------------------- bounds
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
# Integer issue peak: 132 SMs x 4 schedulers x 32 lanes, each dispatching one
# warp instruction per clock (IMAD to the FMA pipe, the rest to the ALU pipe),
# the rate of the H100 data sheet's 67 TFLOP/s float32 peak at one operation per FMA.
# The ALU pipe's 64 lanes alone are no ceiling: the probes' statT lane stages
# ran 8 % faster than their instructions over 132 x 64 lanes allow.
INT32_LANES = 132 * 128
#: peak operations/s by kind; "int32" is set from the card's max SM clock
PEAK = {"int8": 1.979e15}  # dense int8 tensor-core peak (one MAC = two operations)
# 32-bit integer instructions of the kernels' arithmetic (csrc/modarith.cuh),
# counted from the code: a 64-bit add, subtract, compare or select is 2, a
# 64x64-bit low product 4, __umul64hi 8.  Barrett products are counted as
# Shoup ones, which they exceed: the bound stays a lower bound.
CT_OPS = 36  # forward butterfly: condsub, Shoup product, add, sub, twiddle index
GS_OPS = 56  # inverse butterfly: addmod + halfmod, u + q - v, Shoup product, condsub, halfmod
MULMOD_OPS = 24  # a Shoup product with its condsub
ELEM_OPS = 6  # one add, subtract or condsub mod q


def _transform_ops(n: int, inverse: bool) -> int:
    """INT32 instructions of one length-n transform of csrc/modarith.cuh."""
    logn = n.bit_length() - 1
    return n // 2 * logn * (GS_OPS if inverse else CT_OPS) + n * ELEM_OPS * (1 if inverse else 2)


def ntt_work(nb: int, M: int, n: int, inverse: bool):
    """(bytes, operations, kind) of one csrc/ntt.cu launch: nb x M length-n
    transforms, each word read and written once, each modulus's (w, wshoup)
    tables read once."""
    return nb * M * n * 16 + M * n * 16, nb * M * _transform_ops(n, inverse), "int32"


def _ks_sizes():
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

    L, n = CFG.n_limbs, CFG.n
    # forward and inverse (w, wshoup) of every modulus
    return L, n, 2 * (L + 1) * n * 16


def ks_head_work(nb: int):
    """One ks_head launch: nb b-parts (L, N) in, (L+1, L, N) raised digits out."""
    L, n, tables = _ks_sizes()
    fwd, inv = _transform_ops(n, False), _transform_ops(n, True)
    head = L * inv + L * (L + 1) * fwd + L * (L + 2) * n * ELEM_OPS
    return nb * L * n * 8 + nb * (L + 1) * L * n * 8 + tables, nb * head, "int32"


def ks_tail_work(nb_in: int, nb_out: int, K: int, shoup: bool):
    """One ks_tail launch: nb_in raised digits and riders in, K keys (with
    their Shoup companions when `shoup`), nb_out (a, b) pairs out."""
    L, n, tables = _ks_sizes()
    fwd, inv = _transform_ops(n, False), _transform_ops(n, True)
    tail = (2 * (L + 1) * L * n * (MULMOD_OPS + ELEM_OPS) + 2 * inv + 2 * L * fwd
            + 2 * L * n * (2 * ELEM_OPS + MULMOD_OPS) + (L + 2) * n * ELEM_OPS)
    nbytes = ((L + 1) * nb_in * L * n * 8 + L * nb_in * n * 8
              + K * 2 * L * (L + 1) * n * (16 if shoup else 8) + L * nb_out * 2 * n * 8 + tables)
    return nbytes, nb_out * tail, "int32"


def mxu_work(nb: int, M: int, k: int = 1):
    """One csrc/ntt_mxu.cu launch: nb x M N=8192 polynomials in and out, k
    chained transforms each, one set of digit tables per modulus.  A 4-step
    transform's int8 MACs: 8 digit planes of the (R x R) row product over
    K = 8R, then of the (128 x 128) lane product over K = 1024."""
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_mxu

    n = CFG.n
    R = n // 128
    macs = 8 * R * 128 * 8 * R + 8 * R * 128 * 1024
    # every modulus and direction has tables of the same sizes
    tables = sum(a.nbytes for a in ntt_mxu.tables_np(n, CFG.moduli[0], CFG.psi[0], False))
    return nb * M * n * 16 + M * tables, 2 * nb * M * k * macs, "int8"


def bound(work):
    """(µs, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over their peak.  `ops` may be a dict of
    operations by kind (kind None): the tensor cores and the integer lanes
    run side by side, so the slowest kind counts."""
    nbytes, ops, kind = work
    t_ops = max(n / PEAK[k] for k, n in (ops.items() if kind is None else [(kind, ops)]))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def max_sm_clock_mhz() -> float:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0])


def compare(kernel: str, label: str, run, run_plain) -> int:
    """Fail unless run() is torch.equal to run_plain(); the max abs error."""
    import torch

    got, want = run(), run_plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if got.numel() else 0
    if not torch.equal(got, want):
        fail(f"{kernel} {label}: kernel differs from plain (max_abs_err={err})")
    return err


def check(results: dict, card: str, kernel: str, label: str, run, run_plain, work,
          warmup: int = 3, iters: int = 15):
    """Fail unless run() is torch.equal to run_plain(); time both and give
    the bound of `work` (bytes, operations, kind) beside them."""
    err = compare(kernel, label, run, run_plain)
    k_us = time_us(run, warmup, iters)
    p_us = time_us(run_plain, warmup, iters)
    b_us, b_by = bound(work)
    print(f"kernel {kernel} {label}: equal=True kernel_us={k_us:.1f} "
          f"plain_us={p_us:.1f} bound_us={b_us:.2f} ({b_by}) on {card}", flush=True)
    results.setdefault(kernel, []).append((label, err, k_us, p_us, b_us, b_by))


def phase_kernels(card: str, dev):
    import numpy as np
    import torch

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
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

    def case(kernel, label, run, run_plain, work):
        check(results, card, kernel, label, run, run_plain, work)

    # ntt: a multi-modulus case (M=3, nb=64), then rescale's shapes (B=16 x 2 parts)
    x3 = rand((64, n), mod)
    case("ntt", "fwd M=3 nb=64",
         lambda: ntt_stream.transform(x3, mod, CFG.psi, False),
         lambda: ntt_stream.transform_plain(x3, mod, CFG.psi, False), ntt_work(64, 3, n, False))
    case("ntt", "inv M=3 nb=64",
         lambda: ntt_stream.transform(x3, mod, CFG.ipsi, True),
         lambda: ntt_stream.transform_plain(x3, mod, CFG.ipsi, True), ntt_work(64, 3, n, True))
    x1 = rand((2 * B, n), mod[L - 1:L])
    case("ntt", f"inv M=1 nb={2 * B} (rescale)",
         lambda: ntt_stream.transform(x1, mod[L - 1:L], CFG.ipsi[L - 1:L], True),
         lambda: ntt_stream.transform_plain(x1, mod[L - 1:L], CFG.ipsi[L - 1:L], True),
         ntt_work(2 * B, 1, n, True))

    # ks_head: hoisted (the request's baby steps), with an automorphism, and
    # hoisted at the giant steps' batch (3 B)
    b = rand((B, n), mod[:L])
    b48 = rand((3 * B, n), mod[:L])
    e = pow(3, 5, 2 * n)
    ks = [("ks_head", f"hoisted nb={B}", lambda: ksk_ops.ks_head(b, None, CFG),
           lambda: ksk_ops.ks_head_plain(b, None, CFG), ks_head_work(B), 0),
          ("ks_head", f"aut nb={B}", lambda: ksk_ops.ks_head(b, e, CFG),
           lambda: ksk_ops.ks_head_plain(b, e, CFG), ks_head_work(B), 0),
          ("ks_head", f"hoisted nb={3 * B} (giant steps)", lambda: ksk_ops.ks_head(b48, None, CFG),
           lambda: ksk_ops.ks_head_plain(b48, None, CFG), ks_head_work(3 * B), 0)]

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
    nd48 = ksk_ops.ks_head(b48, None, CFG)
    rider48 = rand((3 * B, n), mod[:L])
    # each tail's run takes the cluster (0: the kernel's choice) and its
    # launch's CTA count (one a polynomial)
    ks += [("ks_tail", f"shared K=3 nb={B} (baby steps)",
            lambda c=0: ksk_ops.ks_tail(nd, rider, k3, CFG, kshoup=s3, shared_inputs=True,
                                        cluster=c),
            lambda: ksk_ops.ks_tail_plain(nd, rider, k3, CFG, shared_inputs=True),
            ks_tail_work(B, 3 * B, 3, True), 3 * B * 2),
           ("ks_tail", f"batched K=3 nb={3 * B} (giant steps)",
            lambda c=0: ksk_ops.ks_tail(nd48, rider48, k3, CFG, kshoup=s3, cluster=c),
            lambda: ksk_ops.ks_tail_plain(nd48, rider48, k3, CFG),
            ks_tail_work(3 * B, 3 * B, 3, True), 3 * B * 2),
           ("ks_tail", f"single nb={B} shoup",
            lambda c=0: ksk_ops.ks_tail(nd, rider, prep[0][0], CFG, kshoup=prep[0][1],
                                        cluster=c),
            lambda: ksk_ops.ks_tail_plain(nd, rider, prep[0][0], CFG),
            ks_tail_work(B, B, 1, True), B * 2),
           ("ks_tail", f"single nb={B} barrett",
            lambda c=0: ksk_ops.ks_tail(nd, rider, keys3[0], CFG, cluster=c),
            lambda: ksk_ops.ks_tail_plain(nd, rider, keys3[0], CFG),
            ks_tail_work(B, B, 1, False), B * 2)]
    for kernel, label, run, plain, work, ctas in ks:
        case(kernel, label, run, plain, work)
        ks_graph(results, card, dev, kernel, label, run, ctas)

    # ntt_mxu: each modulus alone, both directions; then the fused chain
    for m, name in enumerate(("q0", "q1", "P")):
        xm = rand((64, n), mod[m:m + 1])
        for inv, roots in ((False, CFG.psi), (True, CFG.ipsi)):
            label = f"{'inv' if inv else 'fwd'} {name} nb=64"
            case("ntt_mxu", label,
                 lambda: ntt_mxu.transform(xm, mod[m:m + 1], roots[m:m + 1], inv),
                 lambda: ntt_mxu.transform_plain(xm, mod[m:m + 1], roots[m:m + 1], inv),
                 mxu_work(64, 1))
    for m, name in ((0, "q0"), (2, "P")):
        xc = rand((16, n), mod[m:m + 1])[0]
        for inv, root in ((False, CFG.psi[m]), (True, CFG.ipsi[m])):
            label = f"{'inv' if inv else 'fwd'} {name} k=3 nb=16"
            case("ntt_mxu_chain", label,
                 lambda: ntt_mxu.chain(xc, mod[m], root, 3, inv),
                 lambda: ntt_mxu.chain_plain(xc, mod[m], root, 3, inv), mxu_work(16, 1, 3))
    ntt_shapes(dev, results)
    mxu_shapes(dev, results)
    return results


def ks_graph(results: dict, card: str, dev, kernel: str, label: str, run, ctas: int):
    """A ks case's graph-burst time (graph_check) beside the cluster a
    ks_tail launch of `ctas` CTAs takes (ks_kernel.cluster_size; ks_head:
    ctas 0, one CTA a polynomial) and, where that is a cluster, the same
    launch forced onto one CTA a polynomial (run(1)) in a graph, its words
    compared; into results["ks_timing"][kernel][label]."""
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ks_kernel as ksk_ops
    from aloha_tpu_torch.probes import common

    g_ms = graph_check(results, card, kernel, label, run)
    rec = {"ms": next(r[2] for r in results[kernel] if r[0] == label) / 1e3, "graph_ms": g_ms,
           "C": ksk_ops.cluster_size(dev, ctas, CFG.n) if ctas else 1}
    if rec["C"] > 1:
        want = run()
        compare(kernel, f"{label} C=1 against C={rec['C']}", lambda: run(1), lambda: want)
        rec["c1_graph_ms"] = common.graph_ms(lambda: run(1))
        print(f"kernel {kernel} {label}: C={rec['C']}, graph {g_ms * 1e3:.2f} us; at C=1 graph "
              f"{rec['c1_graph_ms'] * 1e3:.2f} us on {card}", flush=True)
    results.setdefault("ks_timing", {}).setdefault(kernel, {})[label] = rec


#: lengths (those callers use and the template's ends) and batches (one
#: CTA, about one wave of 132 SMs, two waves) the ntt kernel is held at
NTT_LENGTHS = (2, 16, 128, 1024, 2048, 4096, 8192, 16384)
NTT_NBS = (1, 131, 132, 133, 264)


def ntt_ring(n: int, M: int, inverse: bool):
    """M moduli of length-n transforms and their roots: q0, q1, P up to
    N = 8192, q0, q1, q0 at 16384 (2n does not divide P - 1 there)."""
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

    qs = (CFG.moduli if n <= CFG.n else (CFG.moduli[0], CFG.moduli[1], CFG.moduli[0]))[:M]
    roots = []
    for m, q in enumerate(qs):
        if n <= CFG.n:
            psi = pow(CFG.psi[m], CFG.n // n, q)
        else:
            psi = next(r for r in (pow(g, (q - 1) // (2 * n), q) for g in range(2, 100))
                       if pow(r, n, q) == q - 1)
        roots.append(pow(psi, -1, q) if inverse else psi)
    return tuple(qs), tuple(roots)


def ntt_shapes(dev, results: dict):
    """ntt against its plain version at NTT_LENGTHS x NTT_NBS, M = 1 and 3,
    both directions: words lifted to random points of the input window,
    every third row all at its top (4q - 1 forward, 2q - 1 inverse)."""
    import numpy as np

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.ops import ntt_stream

    t0, count = time.perf_counter(), 0
    for n in NTT_LENGTHS:
        for inv in (False, True):
            top = 2 if inv else 4
            for M in (1, 3):
                qs, roots = ntt_ring(n, M, inv)
                for nb in NTT_NBS:
                    rng = np.random.default_rng(n + M + nb)
                    a = np.stack([rng.integers(0, q, size=(nb, n), dtype=np.uint64)
                                  + np.uint64(q) * rng.integers(0, top, size=(nb, n),
                                                                dtype=np.uint64) for q in qs])
                    for m, q in enumerate(qs):
                        a[m, ::3] = top * q - 1
                    x = cv.from_u64(a, dev)
                    label = f"{'inv' if inv else 'fwd'} M={M} nb={nb} n={n}"
                    err = compare("ntt", label,
                                  lambda: ntt_stream.transform(x, qs, roots, inv),
                                  lambda: ntt_stream.transform_plain(x, qs, roots, inv))
                    results.setdefault("ntt", []).append((label, err))
                    count += 1
    print(f"kernels: ntt equal at {count} shapes (n, direction, M, nb) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def mxu_shapes(dev, results: dict):
    """ntt_mxu and its chain (k = 1, 2, 3) against their plain versions at
    both rings, both directions and nb = 1, 131, 132, 133, 264 (one CTA,
    about one wave of 132 SMs, two waves): polynomial p all zeros, all
    q - 1, all 2^63 - 1 or random words below 2^63, by p mod 4."""
    import numpy as np
    import torch

    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_mxu

    t0, q, count = time.perf_counter(), CFG.moduli[0], 0
    for n in ntt_mxu.KERNEL_RINGS:
        for inv in (False, True):
            root = pow((CFG.ipsi if inv else CFG.psi)[0], CFG.n // n, q)
            for nb in (1, 131, 132, 133, 264):
                a = np.random.default_rng(nb).integers(0, (1 << 63) - 1, size=(nb, n),
                                                       dtype=np.int64)
                a[0::4], a[1::4], a[2::4] = 0, q - 1, (1 << 63) - 1
                x = torch.from_numpy(a).to(dev)
                label = f"{'inv' if inv else 'fwd'} q0 n={n} nb={nb}"
                err = compare("ntt_mxu", label,
                              lambda: ntt_mxu.transform(x[None], (q,), (root,), inv),
                              lambda: ntt_mxu.transform_plain(x[None], (q,), (root,), inv))
                results.setdefault("ntt_mxu", []).append((label, err))
                for k in (1, 2, 3):
                    err = compare("ntt_mxu_chain", f"{label} k={k}",
                                  lambda: ntt_mxu.chain(x, q, root, k, inv),
                                  lambda: ntt_mxu.chain_plain(x, q, root, k, inv))
                    results.setdefault("ntt_mxu_chain", []).append((f"{label} k={k}", err))
                count += 4
    print(f"kernels: ntt_mxu and its chain equal at {count} shapes (n, direction, nb, k) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_bench(card: str, dev, results: dict):
    import numpy as np

    from aloha_tpu_torch import bench
    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_mxu, ntt_pallas, ntt_stream

    # each wrapper at the bench's own shapes and inputs, against its plain version
    n, q, psi = CFG.n, CFG.moduli[0], CFG.psi[0]
    nb, k = BENCH["batch"], BENCH["chain_k"]
    x = cv.from_u64(np.random.default_rng(0).integers(0, q, size=(nb, n), dtype=np.uint64),
                    dev)
    x1 = x[None]
    check(results, card, "ntt", f"fwd q0 (1, {nb}, {n}) bench",
          lambda: ntt_stream.transform(x1, (q,), (psi,), False),
          lambda: ntt_stream.transform_plain(x1, (q,), (psi,), False),
          ntt_work(nb, 1, n, False), 1, 3)
    ntt_timing(card, dev, results)
    check(results, card, "ntt_grid", f"fwd q0 ({nb}, {n}) bench",
          lambda: ntt_pallas.ntt(x, q, psi), lambda: ntt_pallas.ntt_plain(x, q, psi),
          ntt_work(nb, 1, n, False), 1, 3)
    check(results, card, "ntt_mxu", f"fwd q0 (1, {nb}, {n}) bench",
          lambda: ntt_mxu.transform(x1, (q,), (psi,), False),
          lambda: ntt_mxu.transform_plain(x1, (q,), (psi,), False), mxu_work(nb, 1), 1, 3)
    check(results, card, "ntt_mxu_chain", f"fwd q0 k={k} nb={nb} bench",
          lambda: ntt_mxu.chain(x, q, psi, k, False),
          lambda: ntt_mxu.chain_plain(x, q, psi, k, False), mxu_work(nb, 1, k), 0, 1)
    chain_marginal(card, x, q, psi, results)

    # the main path: counts start at 0 here
    counters = {"ntt": ntt_stream.transform, "ntt_grid": ntt_pallas.transform,
                "ntt_mxu": ntt_mxu.transform, "ntt_mxu_chain": ntt_mxu.chain}
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


#: batches the ntt kernel's per-polynomial marginal is taken between
NTT_MARGINAL_NB = (256, 1024)


def ntt_timing(card: str, dev, results: dict):
    """The ntt kernel under q0 at N = 8192, both directions: its marginal ns
    per polynomial over the batch (one launch at each of NTT_MARGINAL_NB,
    probes.common.batch_marginal) beside the bound of one transform (the
    larger of its bytes over the HBM rate and its INT32 instructions over
    the issue peak); then the ISA's shape, one polynomial (M = 1, nb = 1),
    against its plain version, timed eager (as every case) and in a
    CUDA-graph burst (probes.common.graph_ms): the difference is the host's
    share of a launch; and that launch at C = 1 (one CTA a polynomial, not
    the cluster the kernel chooses) in a graph."""
    import numpy as np

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import ntt_torch
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_stream
    from aloha_tpu_torch.probes import common, stream_prof3

    n, q = CFG.n, CFG.moduli[0]
    x = cv.from_u64(np.random.default_rng(1).integers(0, q, size=(1, NTT_MARGINAL_NB[1], n),
                                                      dtype=np.uint64), dev)
    views = {nb: x[:, :nb] for nb in (1, *NTT_MARGINAL_NB)}
    lo, hi = NTT_MARGINAL_NB
    for inv, root in ((False, CFG.psi[0]), (True, CFG.ipsi[0])):
        name = "inv" if inv else "fwd"
        ns, t_lo, t_hi, spread = common.batch_marginal(
            lambda nb: ntt_stream.transform(views[nb], (q,), (root,), inv), NTT_MARGINAL_NB)
        bound_us, bound_by = bound((16 * n, _transform_ops(n, inv), "int32"))
        bound_ns = bound_us * 1e3
        print(f"kernel ntt marginal {name}: {ns:.3f} ns per polynomial bound_ns={bound_ns:.3f} "
              f"({bound_by}) t(nb={lo})={t_lo:.4f} ms t(nb={hi})={t_hi:.4f} ms "
              f"spread={spread:.4f} ms on {card}", flush=True)
        results.setdefault("marginal", {}).setdefault("ntt", {})[
            f"{name} q0 nb={lo}->{hi}"] = (ns, bound_ns)
        if not inv:
            full_ns = stream_prof3.measure(dev)[0]
            print(f"kernel ntt marginal fwd beside probe_fwd_reps full: {full_ns:.3f} ns per "
                  f"transform (REPS {stream_prof3.REPS[0]} -> {stream_prof3.REPS[1]}, nb="
                  f"{common.NB_TIME}) against {ns:.3f} ns per polynomial: {full_ns / ns:.3f} x "
                  f"on {card}", flush=True)
            results["fwd_reps_vs_ntt_ns"] = (full_ns, ns)
        label = f"{name} q0 (1, 1, {n}) isa"
        run = lambda: ntt_stream.transform(views[1], (q,), (root,), inv)  # noqa: E731
        check(results, card, "ntt", label, run,
              lambda: ntt_stream.transform_plain(views[1], (q,), (root,), inv),
              ntt_work(1, 1, n, inv))
        graph_us = common.graph_ms(run) * 1e3
        eager_us = results["ntt"][-1][2]
        w, ws, qs = ntt_torch.tables(n, (q,), (root,), dev)
        c1_us = common.graph_ms(
            lambda: ntt_stream._launch(views[1], w, ws, qs, inv, "ntt", cluster=1)) * 1e3
        chosen = ntt_stream.cluster_size(dev, 1, 1, n, inv)
        print(f"kernel ntt {label}: eager_us={eager_us:.2f} graph_us={graph_us:.2f} "
              f"host share {eager_us - graph_us:.2f} us; C={chosen}, at C=1 "
              f"graph_us={c1_us:.2f} on {card}", flush=True)
        results.setdefault("isa_shape", {})[label] = {
            "ms": eager_us / 1e3, "graph_ms": graph_us / 1e3, "C": chosen,
            "c1_graph_ms": c1_us / 1e3}


#: chain lengths the chain's per-transform marginal is taken between
MXU_MARGINAL_K = (1, 9)


def chain_marginal(card: str, x, q: int, psi: int, results: dict):
    """The chain's marginal ns per polynomial per transform on x (nb =
    probes.common.NB_TIME polynomials): one launch of k transforms at the
    two lengths of MXU_MARGINAL_K (the least of the probes' bursts), beside
    the bound of one transform (int8 MACs over the dense peak); and on the
    same line the parts probe's full marginal on x (REPS 4 -> 12), the same
    device code with the final fold on every transform."""
    from aloha_tpu_torch.ops import ntt_mxu
    from aloha_tpu_torch.probes import common, probe_mxu_parts

    ns, t_lo, t_hi, spread = common.marginal(lambda k: ntt_mxu.chain(x, q, psi, k, False),
                                             MXU_MARGINAL_K)
    full_ns = common.marginal(lambda r: probe_mxu_parts.parts(x, "full", r),
                              probe_mxu_parts.REPS)[0]
    bound_ns = mxu_work(1, 1)[1] / PEAK["int8"] * 1e9
    lo, hi = MXU_MARGINAL_K
    print(f"kernel ntt_mxu_chain marginal: {ns:.3f} ns per polynomial per transform "
          f"bound_ns={bound_ns:.3f} (operations) t(k={lo})={t_lo:.4f} ms t(k={hi})={t_hi:.4f} ms "
          f"spread={spread:.4f} ms nb={x.shape[0]}; probe_mxu_parts full {full_ns:.3f} ns "
          f"({full_ns / ns:.3f} x the chain) on {card}", flush=True)
    results.setdefault("marginal", {}).setdefault("ntt_mxu_chain", {})[
        f"k={lo}->{hi} nb={x.shape[0]}"] = (ns, bound_ns)
    results["parts_full_vs_chain_ns"] = (full_ns, ns)


def phase_serve(card: str, dev):
    import numpy as np
    import torch

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import encoder, keys
    from aloha_tpu_torch import he_torch as ht
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ks_kernel as ksk_ops
    from aloha_tpu_torch.ops import ntt_stream

    n, S = CFG.n, CFG.n // 2
    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    nb_giant = (D + G - 1) // G
    cpu = torch.device("cpu")

    # set-up: keys on the card from a seeded generator, host encoding,
    # diagonals and client encryption on the card
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    sk = keys.gen_secret(CFG, gen, dev)
    baby_steps = list(range(1, G))
    giant_steps = [G * i for i in range(1, nb_giant)]
    ksk = {s: keys.gen_rotation_key(sk, s, CFG, gen) for s in baby_steps + giant_steps}
    for s, k in ksk.items():  # one-time key preparation, as at key load
        ksk_ops.prepare_ksk(k, CFG, aut_exp=pow(3, s, 2 * n))
    rng = np.random.default_rng(SEED + 100)
    dvecs = [rng.uniform(-1, 1, size=S) for _ in range(D)]
    dcoeff = np.stack([encoder.encode(encoder.cleartext_from_slots(d + 0j), CFG)
                       for d in dvecs])
    diags = ht.encode_post(cv.from_u64(dcoeff, dev), CFG)
    requests = []
    for r in range(REQUESTS):
        zs, signed = [], []
        for i in range(B):
            z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
            pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
            signed.append(np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0),
                                   pt[0].astype(np.int64)))
            zs.append(z)
        A, Bp = keys.encrypt(torch.from_numpy(np.stack(signed)).to(dev), sk, CFG, gen)
        requests.append((zs, cv.to_u64(A), cv.to_u64(Bp)))
    print(f"serve: set-up {time.perf_counter() - t0:.1f} s (keygen and encryption of "
          f"{REQUESTS}x{B} ciphertexts on the card, host encoding)", flush=True)

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

    # checks: decrypt error on the card, word-exactness against the port's
    # plain path on CPU tensors (held against he_np by the CPU tests)
    worst = 0.0
    for (zs, _, _), (oa, ob) in zip(requests, outs):
        if oa.shape != (B, 1, n) or ob.shape != (B, 1, n):
            fail(f"output shape {oa.shape}, expected {(B, 1, n)}")
        m = keys.decrypt((cv.from_u64(oa, dev), cv.from_u64(ob, dev)), sk, CFG).cpu().numpy()
        for i, z in enumerate(zs):
            res = np.where(m[i] < 0, m[i] + np.int64(q0), m[i]).astype(np.uint64)
            got = encoder.decode(res[None, :], CFG, limb=0) * (q1 / encoder.DELTA)
            want = sum(d * np.roll(z, -k) for k, d in enumerate(dvecs))
            worst = max(worst, float(np.abs(got - want).max()))
    if not worst < ENVELOPE:
        fail(f"decrypt error {worst} >= {ENVELOPE}")
    diags_cpu = ht.encode_post(cv.from_u64(dcoeff, cpu), CFG)
    if not np.array_equal(cv.to_u64(diags), cv.to_u64(diags_cpu)):
        fail("encode_post of the diagonals differs from the plain path on the CPU")
    _, A, Bp = requests[0]
    t = time.perf_counter()
    ref = ht.rescale(ht.matvec_bsgs(
        (cv.from_u64(A[:1], cpu), cv.from_u64(Bp[:1], cpu)), list(diags_cpu),
        [ksk[s].cpu() for s in baby_steps], [ksk[s].cpu() for s in giant_steps], CFG, g=G,
    ), CFG)
    cpu_s = time.perf_counter() - t
    if not (np.array_equal(outs[0][0][:1], cv.to_u64(ref[0]))
            and np.array_equal(outs[0][1][:1], cv.to_u64(ref[1]))):
        fail("ciphertext 0 of request 0 differs from the plain matvec_bsgs + rescale on the CPU")
    print(f"serve: max decrypt error {worst:.4f} < {ENVELOPE} over {REQUESTS * B} "
          f"ciphertexts; ciphertext 0 word-exact against the plain path on CPU tensors "
          f"(CPU reference: {cpu_s:.1f} s on the host)", flush=True)
    return launches


def _spawn_sharded(D: int, nb: int) -> list:
    """The dry run on D ranks, one per card, NCCL: each rank's result."""
    import tempfile

    import numpy as np

    from aloha_tpu_torch.parallel import dryrun

    with tempfile.TemporaryDirectory() as tmp:
        dryrun.spawn(D, ["--device", "cuda", "--batch", str(nb), "--out", tmp], SHARD_TIMEOUT_S)
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(D)]


def phase_shard(card: str, dev, results: dict):
    import numpy as np
    import torch
    import torch.distributed as dist

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import ntt_torch
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_stream
    from aloha_tpu_torch.parallel import dryrun

    n, q, psi, ipsi = CFG.n, CFG.moduli[0], CFG.psi[0], CFG.ipsi[0]
    nb = SHARD_NB
    rng = np.random.default_rng(SEED + 3)
    # the kernel with each shard's tables: the whole ring (D=1) and the
    # first and last shard of D=2, 4, 8, against the plain stage loop
    for Ds in SHARD_DS:
        x = cv.from_u64(rng.integers(0, q, size=(nb, n // Ds), dtype=np.uint64), dev)
        for d in sorted({0, Ds - 1}):
            for inv, root in ((False, psi), (True, ipsi)):
                w, ws, _ = ntt_torch.shard_tables(n, q, root, Ds, d, inv, dev)
                check(results, card, "ntt_with_tables",
                      f"{'inv' if inv else 'fwd'} D={Ds} d={d} nb={nb}",
                      lambda: ntt_stream.transform_with_tables(x, w, ws, q, inv),
                      lambda: ntt_stream.transform_with_tables_plain(x, w, ws, q, inv),
                      ntt_work(nb, 1, n // Ds, inv), 1, 5)

    # the main path: the sharded transform pair through a real process
    # group, one rank per card; counts start at 0 here
    Dp = 1 << (torch.cuda.device_count().bit_length() - 1)
    ntt_stream.transform_with_tables.launches = 0
    t0 = time.perf_counter()
    if Dp == 1:
        dryrun.init_world_of_one(dev)
        try:
            ranks = [dryrun.run(dev, n, nb, 1, check_rows=2)]
        finally:
            dist.destroy_process_group()
        launches = ntt_stream.transform_with_tables.launches
    else:
        ranks = _spawn_sharded(Dp, nb)
        launches = int(sum(int(r["launches"]) for r in ranks))
    forward = all(bool(r["forward_ok"]) for r in ranks)
    roundtrip = all(bool(r["roundtrip_ok"]) for r in ranks)
    print(f"shard: ntt_sharded + intt_sharded at N={n}, nb={nb}, q0 over D={Dp} "
          f"rank(s), nccl{' (a world of one)' if Dp == 1 else ''}: forward equals "
          f"ntt_np.ntt on the first two polynomials: {forward}; round trip exact: "
          f"{roundtrip}; {time.perf_counter() - t0:.2f} s, "
          f"launches={{'ntt_with_tables': {launches}}} on {card}", flush=True)
    if not forward:
        fail("the sharded forward NTT differs from ntt_np.ntt")
    if not roundtrip:
        fail("the sharded round trip does not give the input back")
    if launches == 0:
        fail("kernel ntt_with_tables was not launched by the sharded path")
    return {"ntt_with_tables": launches}


def _grid_cases(card: str, dev, results: dict):
    """ntt_grid against its plain version, and csrc/ntt.cu at the same
    shapes and inputs, so that the two designs are compared on one card."""
    import numpy as np

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_pallas, ntt_stream

    rng = np.random.default_rng(SEED + 4)
    N = CFG.n
    shapes = [(m, GRID_NB, N, True) for m in range(3)]  # q0, q1, P; both directions
    shapes += [(m, B, N, False) for m in range(2)]  # the encode shape, per limb
    shapes += [(0, GRID_NB, n, True) for n in (128, 1024)]
    for m, nb, n, both in shapes:
        q = CFG.moduli[m]
        for inv in (False, True) if both else (False,):
            root = pow((CFG.ipsi if inv else CFG.psi)[m], N // n, q)
            x = rng.integers(0, q, size=(nb, n), dtype=np.uint64)
            # one row at the top of the input window: < 4q forward, < 2q inverse
            x[-1] += np.uint64(q) * rng.integers(1, 2 if inv else 4, size=n, dtype=np.uint64)
            x = cv.from_u64(x, dev)
            plain = ntt_pallas.intt_plain if inv else ntt_pallas.ntt_plain
            label = f"{'inv' if inv else 'fwd'} {('q0', 'q1', 'P')[m]} nb={nb} n={n}"
            work = ntt_work(nb, 1, n, inv)
            check(results, card, "ntt_grid", label,
                  lambda: ntt_pallas.transform(x, q, root, inv), lambda: plain(x, q, root), work)
            check(results, card, "ntt", label,
                  lambda: ntt_stream.transform(x[None], (q,), (root,), inv),
                  lambda: ntt_stream.transform_plain(x[None], (q,), (root,), inv), work)


#: batches of the grid wrapper's timing at N = 8192: one polynomial, the
#: encode and rotation shapes (16-48), GRID_NB, the bench's and two waves
GRID_TIMING_NB = (1, 16, 32, 48, 64, 256, 264)


def grid_timing(card: str, dev, results: dict):
    """ntt_pallas.transform under q0 at N = 8192, both directions, at
    GRID_TIMING_NB: eager (time_us: calls enqueued back to back) and in a
    CUDA-graph burst (probes.common.graph_ms: no host between the calls),
    with the cluster the kernel chooses; beside it the same launch forced
    to C = 1 (one CTA a polynomial, ntt_stream._launch's internal
    argument) in a graph burst, whose words it compares.  Into
    results["grid_timing"][label]."""
    import numpy as np

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import ntt_torch
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ntt_pallas, ntt_stream
    from aloha_tpu_torch.probes import common

    n, q = CFG.n, CFG.moduli[0]
    x = cv.from_u64(np.random.default_rng(SEED + 7).integers(
        0, q, size=(max(GRID_TIMING_NB), n), dtype=np.uint64), dev)
    for inv, root in ((False, CFG.psi[0]), (True, CFG.ipsi[0])):
        w, ws, qs = ntt_torch.tables(n, (q,), (root,), dev)
        for nb in GRID_TIMING_NB:
            xb = x[:nb]
            run = lambda: ntt_pallas.transform(xb, q, root, inv)  # noqa: E731
            rec = {"ms": time_us(run) / 1e3, "graph_ms": common.graph_ms(run)}
            label = f"{'inv' if inv else 'fwd'} q0 nb={nb} n={n}"
            rec["C"] = ntt_stream.cluster_size(dev, 1, nb, n, inv)
            launch = lambda c: ntt_stream._launch(xb[None], w, ws, qs, inv, "ntt",  # noqa: E731
                                                  cluster=c)
            compare("ntt_grid", f"{label} C=1 against C={rec['C']}", lambda: launch(1)[0][0], run)
            rec["c1_graph_ms"] = common.graph_ms(lambda: launch(1))
            bound_us, _ = bound(ntt_work(nb, 1, n, inv))
            print(f"kernel ntt_grid timing {label}: eager_us={rec['ms'] * 1e3:.2f} "
                  f"graph_us={rec['graph_ms'] * 1e3:.2f} C={rec['C']}; at C=1 "
                  f"graph_us={rec['c1_graph_ms'] * 1e3:.2f} bound_us={bound_us:.2f} on {card}",
                  flush=True)
            results.setdefault("grid_timing", {})[label] = rec


def _crt_slots(ct, sk, CFG):
    """Slots of a ciphertext whose message exceeds one limb (a product at
    Delta^2): decrypt under both limbs, recombine by CRT, centre mod q0 q1."""
    import numpy as np

    from aloha_tpu_torch import encoder, keys

    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    r0, r1 = (keys.decrypt(ct, sk, CFG, limb=k).cpu().numpy().astype(object) for k in (0, 1))
    Q = q0 * q1
    x = (r0 * (q1 * pow(q1, -1, q0)) + r1 * (q0 * pow(q0, -1, q1))) % Q
    x = np.where(x > Q // 2, x - Q, x)
    return encoder.decode_coeffs((x / float(encoder.DELTA)).astype(np.float64), CFG)


def phase_multiply(card: str, dev, results: dict):
    import numpy as np
    import torch

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import encoder, encoder_hw, keys, ntt_np
    from aloha_tpu_torch import he_torch as ht
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.ops import ks_kernel as ksk_ops
    from aloha_tpu_torch.ops import aut, ntt_pallas, ntt_stream

    _grid_cases(card, dev, results)
    grid_timing(card, dev, results)
    n, S, L = CFG.n, CFG.n // 2, CFG.n_limbs
    q0, q1 = CFG.moduli[0], CFG.moduli[1]
    cpu = torch.device("cpu")

    # set-up: keys on the card from a seeded generator, cleartexts on the host
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 5)
    sk = keys.gen_secret(CFG, gen, dev)
    rlk = keys.gen_relin_key(sk, CFG, gen)
    rk = keys.gen_rotation_key(sk, 1, CFG, gen)
    for k in (rlk, rk):  # one-time key preparation, as at key load
        ksk_ops.prepare_ksk(k, CFG)
    rng = np.random.default_rng(SEED + 6)
    batches = []
    for _ in range(MUL_BATCHES):
        zs = [rng.uniform(-1, 1, (B, S)) + 1j * rng.uniform(-1, 1, (B, S)) for _ in range(2)]
        clear = [np.stack([encoder.cleartext_from_slots(v) for v in z]) for z in zs]
        batches.append((zs, clear, [torch.from_numpy(c).to(dev) for c in clear]))
    print(f"multiply: set-up {time.perf_counter() - t0:.1f} s (relinearization and rotation "
          f"keys on the card, {MUL_BATCHES}x2x{B} cleartexts on the host)", flush=True)

    # the main path: counts start at 0 here
    counters = {"ntt_grid": ntt_pallas.transform, "ntt": ntt_stream.transform,
                "ks_head": ksk_ops.ks_head, "ks_tail": ksk_ops.ks_tail, "aut": aut.automorphism}
    for fn in counters.values():
        fn.launches = 0

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    secs = {"encode": [], "multiply": [], "rotate_per_transform": [], "rotate": []}
    outs = []
    for _, _, clear in batches:
        pts, s = timed(lambda: [ht.encode(c, CFG) for c in clear])
        secs["encode"].append(s)
        cts = []
        for pt in pts:  # encrypt the centred limb-0 coefficients
            m = ntt_pallas.intt(pt[:, 0, :], q0, CFG.ipsi[0])
            cts.append(keys.encrypt(torch.where(m > q0 // 2, m - q0, m), sk, CFG, gen))
        def chain():
            r = ht.relinearize(*ht.ct_mul(cts[0], cts[1], CFG), rlk, CFG)
            return r, ht.rescale(r, CFG)

        (relin, res), s = timed(chain)
        secs["multiply"].append(s)
        rot, s = timed(lambda: ht.rotate_per_transform(relin, 1, rk, CFG))
        secs["rotate_per_transform"].append(s)
        fused, s = timed(lambda: ht.rotate(relin, 1, rk, CFG))
        secs["rotate"].append(s)
        outs.append((pts, cts, relin, res, rot, fused))
    launches = {name: fn.launches for name, fn in counters.items()}
    times = "; ".join(f"{k} {[round(x, 4) for x in v]} s" for k, v in secs.items())
    print(f"multiply: {MUL_BATCHES} batches of B={B} pairs (N={n}, L={L}), per batch: "
          f"{times}; launches={launches} on {card}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched by the multiply path")

    # checks
    (_, clear0, _), (pts0, cts0, *_) = batches[0], outs[0]
    for i in (0, 1):  # cleartexts 0 and 1 of both operands
        for op in (0, 1):
            coeff = encoder_hw.encode(clear0[op][i], CFG)
            want = np.stack([ntt_np.ntt(coeff[m], CFG.moduli[m], CFG.psi[m]) for m in range(L)])
            if not np.array_equal(cv.to_u64(pts0[op][i]), want):
                fail(f"he_torch.encode of cleartext {i} (operand {op}) differs from "
                     f"encoder_hw.encode + ntt_np.ntt")
    worst_relin = worst_res = 0.0
    for (zs, _, _), (_, _, relin, res, rot, fused) in zip(batches, outs):
        if relin[0].shape != (B, L, n) or res[0].shape != (B, L - 1, n):
            fail(f"output shapes {relin[0].shape}, {res[0].shape}")
        want = zs[0] * zs[1]
        worst_relin = max(worst_relin, float(np.abs(_crt_slots(relin, sk, CFG) - want).max()))
        m = keys.decrypt(res, sk, CFG).cpu().numpy()
        got = encoder.decode_coeffs(m.astype(np.float64), CFG) * (q1 / encoder.DELTA)
        worst_res = max(worst_res, float(np.abs(got - want).max()))
        if not (torch.equal(rot[0], fused[0]) and torch.equal(rot[1], fused[1])):
            fail("rotate_per_transform differs from the fused rotate")
    if not worst_relin < RELIN_ENVELOPE:
        fail(f"relinearized decrypt error {worst_relin} >= {RELIN_ENVELOPE}")
    if not worst_res < ENVELOPE:
        fail(f"rescaled decrypt error {worst_res} >= {ENVELOPE}")
    t = time.perf_counter()
    one = [tuple(p[:1].to(cpu) for p in ct) for ct in cts0]
    ref = ht.rescale(ht.relinearize(*ht.ct_mul(one[0], one[1], CFG), rlk.to(cpu), CFG), CFG)
    cpu_s = time.perf_counter() - t
    res0 = outs[0][3]
    if not (torch.equal(res0[0][:1].cpu(), ref[0]) and torch.equal(res0[1][:1].cpu(), ref[1])):
        fail("ciphertext 0 differs from the plain ct_mul + relinearize + rescale on the CPU")
    print(f"multiply: encodings word-exact against encoder_hw + ntt_np; max decrypt error "
          f"{worst_relin:.3g} < {RELIN_ENVELOPE} relinearized (Delta^2, CRT), "
          f"{worst_res:.4f} < {ENVELOPE} rescaled, over {MUL_BATCHES * B} products; "
          f"rotate_per_transform equal to the fused rotate on all; ciphertext 0 word-exact "
          f"against the plain path on CPU tensors (CPU reference: {cpu_s:.1f} s on the host)",
          flush=True)
    return launches


AUT_OPS = 6  # per coefficient: index product, mask, compare, 64-bit q - x (2), select
AUT_MAIN = "q0 nb=1 e=9"  # aut's case in the kernels line: the ISA's shape, exponent 3^2
#: (nb, n, k) of phase 8's aut cases, rows k n apart: the ISA's shape, one
#: wave and a half, the multiply path's halves of (b, a) pairs, just above
#: a wave, and the short lengths at nb = 1
AUT_SHAPES = [(1, 8192, 1), (64, 8192, 1), (16, 8192, 2), (133, 8192, 1), (1, 128, 1),
              (1, 1024, 1)]
#: aut cases also timed in a CUDA-graph burst
AUT_GRAPH = (AUT_MAIN, "q0 nb=16 stride=2n e=9", "q0 nb=64 e=9")


def aut_work(nb: int, n: int):
    """One csrc/aut.cu launch: nb length-n polynomials read once and written once."""
    return 2 * nb * n * 8, nb * n * AUT_OPS, "int32"


def _trace_device_events(path):
    """(device events, busy µs) of an exported Chrome trace: the kernels,
    copies and fills the card ran (one stream, so their intervals add)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return len(dev), sum(float(e.get("dur", 0)) for e in dev)


def phase_isa(card: str, dev, results: dict):
    """The HE vector-ISA replay on the card: AlohaDevice + HostRunner
    driving the four canned programs, vaut through csrc/aut.cu."""
    import functools
    import tempfile

    import numpy as np
    import torch

    from aloha_tpu_torch import convert as cv
    from aloha_tpu_torch import encoder, keys, profiling, trace_db
    from aloha_tpu_torch import he_torch as ht
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.isa import programs
    from aloha_tpu_torch.isa.interp import LaunchArgs, VectorProcessor
    from aloha_tpu_torch.ops import aut, ntt_stream
    from aloha_tpu_torch.runtime import host
    from aloha_tpu_torch.runtime.device import AlohaDevice
    from aloha_tpu_torch.torch_backend import TorchBackend

    n, S, L = CFG.n, CFG.n // 2, CFG.n_limbs
    q0 = CFG.moduli[0]
    cpu = torch.device("cpu")

    # 1. the automorphism kernel against its plain version: q0, q1, P; the
    #    12 rotation exponents and 2N-1; one row holding 0 and q; at AUT_SHAPES
    rng = np.random.default_rng(SEED + 7)
    for m, name in enumerate(("q0", "q1", "P")):
        q = CFG.moduli[m]
        for nb, length, k in AUT_SHAPES:
            x = rng.integers(0, q, size=(nb, k, length), dtype=np.uint64)
            x[-1, :, ::3] = 0
            x[-1, :, 1::3] = np.uint64(q)
            x = cv.from_u64(x, dev)[:, 0, :]  # at k > 1 a view of rows k length apart
            shape = (f"{name} nb={nb}" + (f" stride={k}n" if k > 1 else "")
                     + (f" n={length}" if length != n else ""))
            for e in [pow(3, 1 << j, 2 * length) for j in range(12)] + [2 * length - 1]:
                label = f"{shape} e={e}"
                check(results, card, "aut", label,
                      lambda: aut.automorphism(x, e, q), lambda: aut.automorphism_plain(x, e, q),
                      aut_work(nb, length), 2, 10)
                if label in AUT_GRAPH:  # device time, for the order of redesign
                    graph_check(results, card, "aut", label, lambda: aut.automorphism(x, e, q))

    # 2. set-up: the full SPM and KSK memory on the card, rotation keys for
    #    components 1, 2, 4, 8 in their slots, B fresh encryptions and one
    #    cleartext in the host runner's DRAM
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 8)
    sk = keys.gen_secret(CFG, gen, dev)
    rk = {c: keys.gen_rotation_key(sk, c, CFG, gen) for c in (1, 2, 4, 8)}
    device = AlohaDevice(CFG, device=dev)
    for c, k in rk.items():
        device.dma_load_ksk(k, row=device.rotation_ksk_ptr(c))
    zs = rng.uniform(-1, 1, (B, S)) + 1j * rng.uniform(-1, 1, (B, S))
    signed = []
    for z in zs:
        pt = encoder.encode(encoder.cleartext_from_slots(z), CFG)
        signed.append(np.where(pt[0] > q0 // 2, pt[0].astype(np.int64) - np.int64(q0),
                               pt[0].astype(np.int64)))
    A, Bp = keys.encrypt(torch.from_numpy(np.stack(signed)).to(dev), sk, CFG, gen)
    flat = np.concatenate([cv.to_u64(A).reshape(B, -1), cv.to_u64(Bp).reshape(B, -1)], axis=1)
    clear = encoder.cleartext_from_slots(rng.uniform(-1, 1, S) + 1j * rng.uniform(-1, 1, S))
    enc = functools.partial(encoder.encode, cfg=CFG)
    runner = host.HostRunner(device, CFG, encoder=enc)
    ct_bytes = 4 * n * 8
    for i in range(B):
        runner.load_dram(host.DRAM_VP_BASE + i * ct_bytes, flat[i])
    runner.load_dram(host.DRAM_ENCODER_BASE, clear.view(np.uint64))
    print(f"isa: set-up {time.perf_counter() - t0:.1f} s (SPM {device.spm.shape[0]} rows and "
          f"KSK {device.ksk_mem.shape[0]} rows on the card, rotation keys 1, 2, 4, 8, "
          f"{B} encryptions)", flush=True)

    # the op-list in the reference's case3 line format: encode one plaintext,
    # then per ciphertext load, mul_plain, rotate by 2 and by 4, hom_add, store
    CT, PT, R1, R2, R3, R4 = 0, 256, 512, 768, 1024, 1280

    def line(op, spm, b, c):
        return f"{(op << 28) | spm:08x},{b:08x},{c:08x}"

    def block(i):
        return [line(1, CT, 0, i * ct_bytes), line(5, R1, CT, PT), line(7, R2, 2, R1),
                line(7, R3, 4, R1), line(6, R4, R2, R3), line(2, R4, 0, (B + i) * ct_bytes)]

    ops = host.parse_op_list("\n".join([line(3, PT, 0, 0)] + sum((block(i) for i in range(B)), [])))

    # the main path: counts start at 0 here
    counters = {"aut": aut.automorphism, "ntt": ntt_stream.transform}
    for fn in counters.values():
        fn.launches = 0
    prof = profiling.Profiler()
    profiling.profile_device(device, prof)
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(ops)
    torch.cuda.synchronize()
    oplist_s = time.perf_counter() - t
    fresh = {2: [], 5: []}
    for i in range(B):
        device.load_cipher(CT, flat[i])
        device.run_rotate(dest=R2, src=CT, step=2)
        fresh[2].append(device.store_cipher(R2))
        device.run_rotate_any(dest=R3, src=CT, step=5, scratch=R4)
        fresh[5].append(device.store_cipher(R3))
    launches = {name: fn.launches for name, fn in counters.items()}
    kind = {programs.ISRAM_ENCODE_POST: "encode_post", programs.ISRAM_MUL_PLAIN: "mul_plain",
            programs.ISRAM_HOM_ADD: "hom_add", programs.ISRAM_KEYSWITCH: "keyswitch"}
    per_kind = {kind[int(k[len("run_vp[pc="):-1])]: v for k, v in prof.summary().items()}
    print(f"isa: op-list of {len(ops)} ops ({B} ciphertexts) in {oplist_s:.3f} s = "
          f"{len(ops) / oplist_s:.1f} ops/s; host ms per launch (mean, max, count): "
          + "; ".join(f"{k} {v['mean_s'] * 1e3:.2f}, {v['max_s'] * 1e3:.2f}, {v['count']}"
                      for k, v in sorted(per_kind.items()))
          + f"; launches={launches} on {card}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched by the ISA path")

    # 3. checks: every stored ciphertext against he_torch on the card
    ct = (cv.from_u64(flat[:, :L * n].reshape(B, L, n), dev),
          cv.from_u64(flat[:, L * n:].reshape(B, L, n), dev))
    pt = ht.encode_post(cv.from_u64(enc(clear), dev), CFG)
    prod = ht.mul_plain(ct, pt, CFG)
    want = ht.hom_add(ht.rotate(prod, 2, rk[2], CFG), ht.rotate(prod, 4, rk[4], CFG), CFG)
    fused = []  # the fused rotation of the batch, after the warm-up above
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ht.rotate(prod, 2, rk[2], CFG)
        torch.cuda.synchronize()
        fused.append(time.perf_counter() - t)
    fused_s = sorted(fused)[1]
    want = np.concatenate([cv.to_u64(want[0]).reshape(B, -1), cv.to_u64(want[1]).reshape(B, -1)],
                          axis=1)
    stored = np.stack([runner.read_dram(host.DRAM_VP_BASE + (B + i) * ct_bytes, 4 * n)
                       for i in range(B)])
    if stored.shape != (B, 4 * n) or not np.array_equal(stored, want):
        fail("the op-list's ciphertexts differ from mul_plain -> rotate -> hom_add of he_torch")

    # ciphertext 0 against the port's own replay on CPU tensors
    t = time.perf_counter()
    cpu_dev = AlohaDevice(CFG, device=cpu)
    for c in (2, 4):
        cpu_dev.dma_load_ksk(rk[c].cpu(), row=cpu_dev.rotation_ksk_ptr(c))
    cpu_runner = host.HostRunner(cpu_dev, CFG, encoder=enc)
    cpu_runner.load_dram(host.DRAM_VP_BASE, flat[0])
    cpu_runner.load_dram(host.DRAM_ENCODER_BASE, clear.view(np.uint64))
    cpu_runner.run(ops[:1 + 6])
    if not np.array_equal(cpu_runner.read_dram(host.DRAM_VP_BASE + B * ct_bytes, 4 * n), stored[0]):
        fail("ciphertext 0 of the op-list differs from the replay on CPU tensors")
    cpu_s = time.perf_counter() - t

    # a key-switch launch recorded on the card verifies instruction by
    # instruction against the replay on CPU tensors, through a .tdb file
    device.load_cipher(CT, flat[0])
    args = LaunchArgs(pc=programs.ISRAM_KEYSWITCH, src0=CT, rslt=R2, step=pow(3, 2, 2 * n),
                      ksk_ptr=device.rotation_ksk_ptr(2))
    rows = trace_db.record(device.vp, device.isram, device.spm, device.ksk_mem, args)
    with tempfile.TemporaryDirectory() as tmp:
        trace_db.write(f"{tmp}/keyswitch.tdb", rows, n)
        back = trace_db.read(f"{tmp}/keyswitch.tdb")
        bad = trace_db.verify(VectorProcessor(CFG, TorchBackend(cpu)), device.isram,
                              device.spm.cpu(), device.ksk_mem.cpu(), args, back)
        if bad or not back:
            fail(f"the key-switch trace of the card differs from the CPU replay: {bad[:5]}")
        # the device's state round trip
        device.save_state(f"{tmp}/state.npz")
        again = AlohaDevice(CFG, device=dev)
        again.load_state(f"{tmp}/state.npz")
        if not (torch.equal(again.spm, device.spm) and torch.equal(again.ksk_mem, device.ksk_mem)):
            fail("save_state -> load_state is not word-exact")

    # the rotated fresh encryptions decrypt to the rotated slots
    worst = {}
    for step, outs in fresh.items():
        got = np.stack(outs)
        c = (cv.from_u64(got[:, :L * n].reshape(B, L, n), dev),
             cv.from_u64(got[:, L * n:].reshape(B, L, n), dev))
        m = keys.decrypt(c, sk, CFG).cpu().numpy()
        err = 0.0
        for i, z in enumerate(zs):
            res = np.where(m[i] < 0, m[i] + np.int64(q0), m[i]).astype(np.uint64)
            err = max(err, float(np.abs(encoder.decode(res[None, :], CFG, limb=0)
                                        - np.roll(z, -step)).max()))
        worst[step] = err
        if not err < RELIN_ENVELOPE:
            fail(f"run_rotate{'_any' if step == 5 else ''} step {step}: decrypt error {err} "
                 f">= {RELIN_ENVELOPE}")
    print(f"isa: {B} ciphertexts word-exact against he_torch on the card; ciphertext 0 "
          f"word-exact against the CPU replay ({cpu_s:.1f} s on the host); the key-switch "
          f"trace ({len(rows)} rows) verifies against the CPU; save_state/load_state exact; "
          f"decrypt error run_rotate(2) {worst[2]:.3g}, run_rotate_any(5) {worst[5]:.3g} "
          f"< {RELIN_ENVELOPE}", flush=True)

    # 4. one key-switch launch under torch.profiler: device events and busy
    #    share, beside the fused he_torch.rotate of the same batch
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.Profiler(trace_dir=tmp).device_trace("keyswitch"):
            device.run_rotate(dest=R2, src=CT, step=2)
        traced_s = prof.records[-1].seconds  # the launch alone, synchronised, profiler on
        n_dev, busy_us = _trace_device_events(f"{tmp}/keyswitch.json")
    ks_ms = per_kind["keyswitch"]["mean_s"] * 1e3
    print(f"isa: one keyswitch launch under torch.profiler: {n_dev} device events, device busy "
          f"{busy_us / 1e3:.3f} ms of the {traced_s * 1e3:.2f} ms launch profiled "
          f"(share {busy_us / 1e3 / (traced_s * 1e3):.4f}; of the unprofiled {ks_ms:.2f} ms: "
          f"{busy_us / 1e3 / ks_ms:.4f}); fused he_torch.rotate of the batch of {B} (median of "
          f"3 after warm-up): {fused_s * 1e3:.2f} ms ({fused_s * 1e3 / B:.3f} ms per "
          f"ciphertext) against {ks_ms:.2f} ms per ciphertext through the ISA, on {card}",
          flush=True)
    return launches


def probe_work(nb: int, reps: int, ops_per_rep: int, table_bytes: int):
    """One probe launch: nb polynomials read and written once, the
    `table_bytes` of the (w, wshoup) tables its steps take read once,
    `reps` steps of `ops_per_rep` INT32 instructions each."""
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

    return 2 * nb * CFG.n * 8 + table_bytes, nb * reps * ops_per_rep, "int32"


def rate_work(bp: int, reps: int):
    """One rate-probe launch: x (8, 64 bp, 128) int8 in and out, w once,
    `reps` repetitions of 64 digit-pair products and the combine."""
    from aloha_tpu_torch.probes import probe_mxu as P

    return (2 * 8 * bp * 64 * 128 + 8 * 128 * 128,
            {"int8": 2 * P.MACS * bp * reps, "int32": P.OPS * bp * reps}, None)


def parts_work(variant: str, nb: int, reps: int):
    """One parts-probe launch: nb polynomials in and out, the tables the
    variant reads (the stream and the constants of ntt_mxu.kernel_tables)
    once, `reps` transforms of the variant."""
    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.probes import probe_mxu_parts as P

    nbytes = 2 * nb * CFG.n * 8 + P.TABLE_BYTES[variant]
    ops = {"int32": P.OPS[variant] * nb * reps}
    if variant != "vpu":
        ops["int8"] = 2 * P.MACS * nb * reps
    return nbytes, ops, None


def dyn_work(nb: int, reps: int, ops_per_rep: int, table: bool):
    """One dyn-probe launch: nb (64, 128) u32 blocks in and out, the
    (13, 64, 128) table once when `table`, `reps` repetitions."""
    return 2 * nb * 8192 * 4 + (13 * 8192 * 4 if table else 0), nb * reps * ops_per_rep, "int32"


def dma_work(nb: int, block_bytes: int, once_bytes: int, ops_per_block: int):
    """One copy-pipeline launch: nb blocks (or polynomials), each moving
    `block_bytes` in and out, `once_bytes` of tables read once, the step's
    INT32 instructions."""
    return nb * block_bytes + once_bytes, nb * ops_per_block, "int32"


def _library_rate(card: str, results: dict, x, w):
    """torch._int_mm of the rate probe's products ([x_0 ... x_7] (M, 1024)
    by the column-major Wcat (1024, 1024), `probe_mxu.int_mm_operands`):
    its accumulators against the plain version's, its time eager and in a
    graph burst.  The port never calls it."""
    import torch

    from aloha_tpu_torch.probes import common, probe_mxu

    X, Wcat = probe_mxu.int_mm_operands(x, w)
    acc = torch._int_mm(X, Wcat).reshape(x.shape[1], 8, 128).permute(1, 0, 2)
    if not torch.equal(acc.to(torch.int64), probe_mxu.accumulators_plain(x, w)):
        fail("torch._int_mm's accumulators differ from the rate probe's plain ones")
    eager_us = time_us(lambda: torch._int_mm(X, Wcat))
    graph_us = common.graph_ms(lambda: torch._int_mm(X, Wcat)) * 1e3
    print(f"library torch._int_mm ({x.shape[1]}, 1024) x (1024, 1024) column-major int8 -> "
          f"int32: eager {eager_us:.2f} us, graph {graph_us:.2f} us per call "
          f"({2 * probe_mxu.MACS * x.shape[1] / 64 / (eager_us * 1e-6) / 1e12:.1f} TOP/s eager) "
          f"on {card}", flush=True)
    results.setdefault("library", {})["probe_mxu"] = eager_us / 1e3
    results.setdefault("library_graph", {})["probe_mxu"] = graph_us / 1e3


def graph_check(results: dict, card: str, kernel: str, label: str, fn) -> float:
    """The graph-burst time (ms) of one call of the kernel's case `label`,
    beside its eager time from `check`; into results["graph"][kernel][label]."""
    from aloha_tpu_torch.probes import common

    g_us = common.graph_ms(fn) * 1e3
    k_us = next(r[2] for r in results[kernel] if r[0] == label)
    print(f"kernel {kernel} {label}: eager {k_us:.2f} us, graph {g_us:.2f} us per call on {card}",
          flush=True)
    results.setdefault("graph", {}).setdefault(kernel, {})[label] = g_us / 1e3
    return g_us / 1e3


def phase_probes(card: str, dev, results: dict):
    """The eight step probes and the four copy pipelines: every variant and
    mode against its plain version, then the probes' own marginal timings
    (the main path)."""
    import numpy as np
    import torch

    from aloha_tpu_torch.probes import (common, op_probe, probe_dynstage, probe_dynsub,
                                        probe_mxu, probe_mxu_parts, stream_prof, stream_prof2,
                                        stream_prof3)
    from aloha_tpu_torch.probes import dma_bisect as D
    from aloha_tpu_torch.probes import dma_bisect_doublebuf as DB
    from aloha_tpu_torch.probes import dma_bisect_stages as DS
    from aloha_tpu_torch.probes import dma_bisect_tblread as DT

    PROBE_NB, R = common.SMALL  # polynomials and repetitions of the timed comparisons
    all_rows = common.table_bytes(range(common.LOGN))  # a whole forward transform's twiddles
    # (kernel, label, wrapper(x, reps), plain(x, reps), ops per repetition,
    # timed REPS, table bytes a launch reads)
    cases = [("probe_ops", v, lambda x, r, v=v: op_probe.probe_ops(x, v, r),
              lambda x, r, v=v: op_probe.probe_ops_plain(x, v, r), op_probe.OPS[v],
              op_probe.REPS, op_probe.TABLE_BYTES[v]) for v in op_probe.VARIANTS]
    cases.append(("probe_fwd_reps", "fwd", stream_prof3.fwd_reps, stream_prof3.fwd_reps_plain,
                  stream_prof3.NEEDED_OPS, stream_prof3.REPS, all_rows))
    cases += [("probe_stage_modes", m, lambda x, r, m=m: stream_prof.stage_modes(x, m, r),
               lambda x, r, m=m: stream_prof.stage_modes_plain(x, m, r),
               stream_prof.NEEDED_OPS[m], stream_prof.REPS, 0 if m == "rollsonly" else all_rows)
              for m in stream_prof.MODES]
    for case in stream_prof2.CASES:
        m, k = stream_prof2.parse(case)
        cases.append(("probe_lane_stages", case,
                      lambda x, r, m=m, k=k: stream_prof2.lane_stages(x, m, k, r),
                      lambda x, r, m=m, k=k: stream_prof2.lane_stages_plain(x, m, k, r),
                      stream_prof2.ops(m, k), stream_prof2.REPS, stream_prof2.table_bytes(m, k)))
    # the main path's shape (NB_TIME polynomials) at its lower REPS: compared,
    # not timed (the plain versions run a few hundred ms there)
    t0, nb = time.perf_counter(), common.NB_TIME
    xm = common.resident_data(nb, dev)
    for kernel, label, run, plain, _, reps, _ in cases:
        r = reps[0]
        err = compare(kernel, f"{label} nb={nb} reps={r}", lambda: run(xm, r), lambda: plain(xm, r))
        results.setdefault(kernel, []).append((f"{label} nb={nb} reps={r}", err))
    print(f"probes: {len(cases)} cases equal at nb={nb}, their lower REPS, in "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    del xm
    x = common.resident_data(PROBE_NB, dev)
    for kernel, label, run, plain, ops, _, tables in cases:
        check(results, card, kernel, f"{label} nb={PROBE_NB} reps={R}", lambda: run(x, R),
              lambda: plain(x, R), probe_work(PROBE_NB, R, ops, tables), 1, 3)
    graph_check(results, card, "probe_lane_stages", f"full-13 nb={PROBE_NB} reps={R}",
                lambda: stream_prof2.lane_stages(x, "full", 13, R))
    graph_check(results, card, "probe_ops", f"v0 nb={PROBE_NB} reps={R}",
                lambda: op_probe.probe_ops(x, "v0", R))
    # the lane kernel's edge sweep: batches of one, three and 133 polynomials,
    # stage counts that take s mod 7 and s mod 13 apart, 0 and R repetitions
    t0, n_edge = time.perf_counter(), 0
    for nb_e in LANE_EDGE_NBS:
        xe = common.resident_data(nb_e, dev, seed=nb_e)
        for m in stream_prof2.MODES:
            for k in LANE_EDGE_NSTAGES:
                for r in (0, R):
                    label = f"{m}-{k} nb={nb_e} reps={r}"
                    err = compare("probe_lane_stages", label,
                                  lambda: stream_prof2.lane_stages(xe, m, k, r),
                                  lambda: stream_prof2.lane_stages_plain(xe, m, k, r))
                    results["probe_lane_stages"].append((label, err))
                    n_edge += 1
    print(f"probes: probe_lane_stages edge sweep, {n_edge} cases equal (nb {LANE_EDGE_NBS}, "
          f"nstages {LANE_EDGE_NSTAGES}, reps 0 and {R}, every mode) in "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    # probe_ops' edge sweep: every variant at a few batches and repetitions
    t0, n_edge = time.perf_counter(), 0
    for nb_e in OPS_EDGE_NBS:
        xe = common.resident_data(nb_e, dev, seed=nb_e)
        for v in op_probe.VARIANTS:
            for r in OPS_EDGE_REPS:
                label = f"{v} nb={nb_e} reps={r}"
                err = compare("probe_ops", label, lambda: op_probe.probe_ops(xe, v, r),
                              lambda: op_probe.probe_ops_plain(xe, v, r))
                results["probe_ops"].append((label, err))
                n_edge += 1
    print(f"probes: probe_ops edge sweep, {n_edge} cases equal (nb {OPS_EDGE_NBS}, reps "
          f"{OPS_EDGE_REPS}, every variant) in {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    # the forward transforms' and the stage modes' edge sweep: the same
    # batches and repetitions, and nb = 3 on the edge words of [0, 4q)
    t0, n_edge = time.perf_counter(), 0
    stage_cases = [("probe_fwd_reps", "fwd", stream_prof3.fwd_reps, stream_prof3.fwd_reps_plain)]
    stage_cases += [("probe_stage_modes", m, lambda x, r, m=m: stream_prof.stage_modes(x, m, r),
                     lambda x, r, m=m: stream_prof.stage_modes_plain(x, m, r))
                    for m in stream_prof.MODES]
    inputs = [(f"nb={b}", common.resident_data(b, dev, seed=b)) for b in OPS_EDGE_NBS]
    inputs.append(("edge words nb=3", stream_prof.edge_data(3, dev)))
    for tag, xe in inputs:
        for kernel, mode, run, plain in stage_cases:
            for r in OPS_EDGE_REPS:
                label = f"{mode} {tag} reps={r}"
                err = compare(kernel, label, lambda: run(xe, r), lambda: plain(xe, r))
                results[kernel].append((label, err))
                n_edge += 1
    print(f"probes: probe_fwd_reps and probe_stage_modes edge sweep, {n_edge} cases equal (nb "
          f"{OPS_EDGE_NBS} and the edge words, reps {OPS_EDGE_REPS}, every mode) in "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)

    # the tensor-core and runtime-stage probes: (kernel, label, inputs(nb),
    # wrapper(*inputs, reps), plain(*inputs, reps), work(nb, reps), REPS)
    def rate_inputs(nb):
        x, w = probe_mxu.data(nb, dev)
        return x, w, probe_mxu.w_image(w)  # w laid out once, outside the timed launches

    more = [("probe_mxu", "rate", rate_inputs,
             lambda x, w, image, r: probe_mxu.launch_rate(x, image, r),
             lambda x, w, image, r: probe_mxu.digit_products_plain(x, w, r), rate_work,
             probe_mxu.REPS)]
    more += [("probe_mxu_parts", v, lambda nb: (probe_mxu_parts.data(nb, dev),),
              lambda x, r, v=v: probe_mxu_parts.parts(x, v, r),
              lambda x, r, v=v: probe_mxu_parts.parts_plain(x, v, r),
              lambda nb, r, v=v: parts_work(v, nb, r), probe_mxu_parts.REPS)
             for v in probe_mxu_parts.VARIANTS]
    more += [("probe_dynstage", "lanes",
              lambda nb: (probe_dynstage.data(nb, dev), probe_dynstage.table(dev)),
              probe_dynstage.dynstage, probe_dynstage.dynstage_plain,
              lambda nb, r: dyn_work(nb, r, probe_dynstage.OPS, True), probe_dynstage.REPS),
             ("probe_dynsub", "rows", lambda nb: (probe_dynstage.data(nb, dev),),
              probe_dynsub.dynsub, probe_dynsub.dynsub_plain,
              lambda nb, r: dyn_work(nb, r, probe_dynsub.OPS, False), probe_dynsub.REPS)]
    t0 = time.perf_counter()
    for kernel, label, inputs, run, plain, _, reps in more:
        args, r = inputs(nb), reps[0]
        err = compare(kernel, f"{label} nb={nb} reps={r}", lambda: run(*args, r),
                      lambda: plain(*args, r))
        results.setdefault(kernel, []).append((f"{label} nb={nb} reps={r}", err))
    print(f"probes: {len(more)} tensor-core and runtime-stage cases equal at nb={nb}, their "
          f"lower REPS, in {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    # the rate kernel through its entry point on whole and half 128-row tiles
    for bp, r in RATE_SHAPES:
        x, w = probe_mxu.data(bp, dev, seed=bp + r)
        err = compare("probe_mxu", f"rate nb={bp} reps={r}",
                      lambda: probe_mxu.digit_products(x, w, r),
                      lambda: probe_mxu.digit_products_plain(x, w, r))
        results.setdefault("probe_mxu", []).append((f"rate nb={bp} reps={r}", err))
    # the parts probe's edge sweep: every variant past one wave at one CTA an
    # SM, 0-3 repetitions, polynomials at the ends of the fold's range
    t0, n_edge = time.perf_counter(), 0
    for nb_e in probe_mxu_parts.EDGE_NBS:
        xe = probe_mxu_parts.edge_data(nb_e, dev)
        for v in probe_mxu_parts.VARIANTS:
            for r in OPS_EDGE_REPS:
                label = f"{v} nb={nb_e} reps={r}"
                err = compare("probe_mxu_parts", label,
                              lambda: probe_mxu_parts.parts(xe, v, r),
                              lambda: probe_mxu_parts.parts_plain(xe, v, r))
                results["probe_mxu_parts"].append((label, err))
                n_edge += 1
    del xe
    print(f"probes: probe_mxu_parts edge sweep, {n_edge} cases equal (nb {probe_mxu_parts.EDGE_NBS}, reps "
          f"{OPS_EDGE_REPS}, every variant) in {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    # timed at a small shape (1 warm-up, 3 calls); the rate probe also at the
    # measured BP with one repetition, timed as its library call is (3
    # warm-ups, 15 calls, and in a graph burst)
    for kernel, label, inputs, run, plain, work, _ in more:
        shapes = [(PROBE_NB, R, 1, 3)] + ([(nb, 1, 3, 15)] if kernel == "probe_mxu" else [])
        for small, r, warmup, iters in shapes:
            args = inputs(small)
            check(results, card, kernel, f"{label} nb={small} reps={r}", lambda: run(*args, r),
                  lambda: plain(*args, r), work(small, r), warmup, iters)
    x, w, image = rate_inputs(nb)
    graph_check(results, card, "probe_mxu", f"rate nb={nb} reps=1",
                lambda: probe_mxu.launch_rate(x, image, 1))
    _library_rate(card, results, x, w)
    del x, w, image

    # the copy pipelines: (kernel, label, wrapper(x), plain(x), inputs, the
    # compared batches, the last of them also timed, work(nb)); the inputs
    # are drawn once at the larger timed batch, a batch is their first nb
    t0 = time.perf_counter()
    xb, xp, tt = D.blocks(D.NBS[1], dev), common.resident_data(DS.NBS[1], dev), DT.table(dev)
    dma = [("probe_dma_copy", m, lambda x, m=m: D.dma_copy(x, m),
            lambda x, m=m: D.dma_copy_plain(x, m), xb, (1, 16, 131, 132, 133, D.NBS[0]),
            lambda nb, m=m: dma_work(nb, D.BLOCK_BYTES, 0, D.OPS[m])) for m in D.MODES]
    dma += [("probe_dma_doublebuf", "roll-swap", DB.doublebuf, DB.doublebuf_plain, xb,
             (32, 133, D.NBS[0]), lambda nb: dma_work(nb, D.BLOCK_BYTES, 0, DB.OPS)),
            ("probe_dma_tblread", "table", lambda x: DT.tblread(tt, x),
             lambda x: DT.tblread_plain(tt, x), xb, (32, 133, D.NBS[0]),
             lambda nb: dma_work(nb, D.BLOCK_BYTES, DT.TABLE_BYTES, DT.OPS))]
    # the stages at every count on the edge batches (1 polynomial; more
    # chunks than SMs; than two CTAs an SM hold) and the edge words, timed
    # at the lower timed batch for DS.NSTAGES
    dma += [("probe_dma_stages", f"nstages={k}", lambda x, k=k: DS.stages(x, k),
             lambda x, k=k: DS.stages_plain(x, k), xp,
             (1, 32, 133, 264) + ((DS.NBS[0],) if k in DS.NSTAGES else ()),
             lambda nb, k=k: dma_work(nb, DS.POLY_BYTES, 2 * common.N * 8, DS.ops(k)))
            for k in range(DS.MAX_STAGES + 1)]
    edge = stream_prof.edge_data(3, dev)
    for k in range(DS.MAX_STAGES + 1):
        err = compare("probe_dma_stages", f"nstages={k} edge nb=3", lambda: DS.stages(edge, k),
                      lambda: DS.stages_plain(edge, k))
        results.setdefault("probe_dma_stages", []).append((f"nstages={k} edge nb=3", err))
    for kernel, label, run, plain, x, nbs, work in dma:
        timed = kernel != "probe_dma_stages" or nbs[-1] == DS.NBS[0]
        for b in nbs[:-1] if timed else nbs:
            err = compare(kernel, f"{label} nb={b}", lambda: run(x[:b]), lambda: plain(x[:b]))
            results.setdefault(kernel, []).append((f"{label} nb={b}", err))
        if timed:
            b = nbs[-1]
            check(results, card, kernel, f"{label} nb={b}", lambda: run(x[:b]),
                  lambda: plain(x[:b]), work(b))
    y = torch.empty_like(xb)
    b = D.NBS[0]
    graph_check(results, card, "probe_dma_copy", f"copy nb={b}", lambda: D.dma_copy(xb[:b], "copy"))
    lib_us = time_us(lambda: y[:b].copy_(xb[:b]))
    lib_graph_us = common.graph_ms(lambda: y[:b].copy_(xb[:b])) * 1e3
    results.setdefault("library", {})["probe_dma_copy"] = lib_us / 1e3
    results.setdefault("library_graph", {})["probe_dma_copy"] = lib_graph_us / 1e3
    print(f"library torch copy_ nb={b}: eager {lib_us:.2f} us, graph {lib_graph_us:.2f} us per "
          f"call ({b * D.BLOCK_BYTES / lib_us / 1e3:.1f} GB/s eager) on {card}", flush=True)
    print(f"probes: {len(dma)} copy-pipeline cases equal at the scripts' batches, nb=133 and "
          f"the timed lower nb (the stages at 0-{DS.MAX_STAGES} stages, nb = 1, 32, 133, 264 "
          f"and the edge words), in {time.perf_counter() - t0:.1f} s with the inputs drawn on "
          f"{card}", flush=True)

    # the main path: counts start at 0 here
    counters = {"probe_ops": op_probe.probe_ops, "probe_fwd_reps": stream_prof3.fwd_reps,
                "probe_stage_modes": stream_prof.stage_modes,
                "probe_lane_stages": stream_prof2.lane_stages,
                "probe_mxu": probe_mxu.digit_products, "probe_mxu_parts": probe_mxu_parts.parts,
                "probe_dynstage": probe_dynstage.dynstage, "probe_dynsub": probe_dynsub.dynsub,
                "probe_dma_copy": D.dma_copy, "probe_dma_doublebuf": DB.doublebuf,
                "probe_dma_stages": DS.stages, "probe_dma_tblread": DT.tblread}
    for fn in counters.values():
        fn.launches = 0
    def ops_ns(ops: dict) -> float:
        """The bound of a repetition on resident data: operations only."""
        return max(n / PEAK[k] for k, n in ops.items()) * 1e9

    int32_ns = lambda ops: ops_ns({"int32": ops})  # noqa: E731
    t0 = time.perf_counter()
    measured = {
        "probe_ops": [(v, ns, lo, hi, None, op_probe.REPS, int32_ns(op_probe.OPS[v]))
                      for v, ns, lo, hi in op_probe.measure(op_probe.VARIANTS, dev)],
        "probe_fwd_reps": [("fwd", *stream_prof3.measure(dev), None, stream_prof3.REPS,
                            int32_ns(stream_prof3.NEEDED_OPS))],
        "probe_stage_modes": [(m, ns, lo, hi, None, stream_prof.REPS,
                               int32_ns(stream_prof.NEEDED_OPS[m]))
                              for m, ns, lo, hi in stream_prof.measure(stream_prof.MODES, dev)],
        "probe_lane_stages": [(c, ns, lo, hi, None, stream_prof2.REPS,
                               int32_ns(stream_prof2.ops(*stream_prof2.parse(c))))
                              for c, ns, lo, hi in stream_prof2.measure(stream_prof2.CASES, dev)],
        "probe_mxu": [("rate", *probe_mxu.measure(dev), probe_mxu.REPS,
                       ops_ns(rate_work(1, 1)[1]))],
        "probe_mxu_parts": [(v, ns, lo, hi, spread, probe_mxu_parts.REPS,
                             ops_ns(parts_work(v, 1, 1)[1]))
                            for v, ns, lo, hi, spread in probe_mxu_parts.measure(
                                probe_mxu_parts.VARIANTS, dev)],
        "probe_dynstage": [("lanes", *probe_dynstage.measure(dev), probe_dynstage.REPS,
                            int32_ns(probe_dynstage.OPS))],
        "probe_dynsub": [("rows", *probe_dynsub.measure(dev), probe_dynsub.REPS,
                          int32_ns(probe_dynsub.OPS))],
    }
    bytes_ns = D.bound_ns(D.BLOCK_BYTES), "bytes"
    copies = {
        "probe_dma_copy": [(m, mm, bytes_ns) for m, *mm in D.measure(D.MODES, dev, xb)],
        "probe_dma_doublebuf": [("roll-swap", DB.measure(dev, xb), bytes_ns)],
        "probe_dma_tblread": [("table", DT.measure(dev, xb), bytes_ns)],
        "probe_dma_stages": [(f"nstages={k}", mm, DS.bound(k, PEAK["int32"]))
                             for k, *mm in DS.measure(DS.NSTAGES, dev, xp)],
    }
    launches = {name: fn.launches for name, fn in counters.items()}
    lib = D.measure_library(dev, xb)
    split = D.measure_split(dev, xb)
    del xb, xp, y
    for kernel, rows in copies.items():
        nbytes, nbs, unit = ((DS.POLY_BYTES, DS.NBS, "polynomial") if kernel == "probe_dma_stages"
                             else (D.BLOCK_BYTES, D.NBS, "block"))
        for label, m, bound_ns in rows:
            print("probe " + D.report(f"{kernel} {label}", m, nbytes, card, nbs, unit, bound_ns),
                  flush=True)
            results.setdefault("marginal", {}).setdefault(kernel, {})[label] = (m[0], bound_ns[0])
    print("library " + D.report("torch copy_", lib, D.BLOCK_BYTES, card), flush=True)
    floor = 2 * lib[0]  # two 32 KiB blocks a polynomial
    stages = ", ".join(f"{label} {m[0]:.3f} ns ({m[0] / floor:.2f} x)"
                       for label, m, _ in copies["probe_dma_stages"])
    print(f"probe probe_dma_stages beside the copy floor: {stages} per polynomial; torch copy_ "
          f"{floor:.3f} ns per polynomial (two blocks) on {card}", flush=True)
    for line in D.split_report(split, card):
        print("probe " + line, flush=True)
    for kernel, rows in measured.items():
        for label, ns, t_lo, t_hi, spread, reps, bound_ns in rows:
            extra = ""
            if spread is not None:
                extra = (f" spread={spread:.4f} ms (t({reps[1]}) - t({reps[0]}) = "
                         f"{(t_hi - t_lo) / spread if spread else float('inf'):.1f} spreads)")
            per_ns = (lambda v: v / ns) if ns > 0 else (lambda v: float("nan"))
            if kernel == "probe_mxu":
                lib_ns = results["library"]["probe_mxu"] * 1e6 / common.NB_TIME
                extra += (f" {per_ns(probe_mxu.MACS) / 1e3:.1f} T-MACs/s; torch._int_mm "
                          f"{lib_ns:.3f} ns per polynomial")
            if kernel == "probe_mxu_parts":
                tb = probe_mxu_parts.TABLE_BYTES[label]
                extra += f" table_bytes={tb} ({per_ns(tb):.1f} GB/s through L2)"
            if kernel in ("probe_fwd_reps", "probe_stage_modes"):
                frozen = stream_prof3.OPS if label == "fwd" else stream_prof.OPS[label]
                extra += f" (NEEDED_OPS; the frozen OPS: bound_ns={int32_ns(frozen):.3f})"
                results.setdefault("ops_bound_ns", {}).setdefault(kernel, {})[label] = (
                    int32_ns(frozen))
            print(f"probe {kernel} {label}: marginal_ns={ns:.3f} per polynomial per repetition "
                  f"bound_ns={bound_ns:.3f} (operations) t({reps[0]})={t_lo:.4f} ms "
                  f"t({reps[1]})={t_hi:.4f} ms nb={common.NB_TIME}{extra} on {card}", flush=True)
            results.setdefault("marginal", {}).setdefault(kernel, {})[label] = (ns, bound_ns)
    parts_ns = {v: results["marginal"]["probe_mxu_parts"][v][0] for v in probe_mxu_parts.VARIANTS}
    print(f"probe probe_mxu_parts split: full {parts_ns['full']:.1f} ns, mxu {parts_ns['mxu']:.1f} "
          f"+ vpu {parts_ns['vpu']:.1f} = {parts_ns['mxu'] + parts_ns['vpu']:.1f} ns, the larger "
          f"{max(parts_ns['mxu'], parts_ns['vpu']):.1f} ns on {card}", flush=True)
    print(f"probes: measured in {time.perf_counter() - t0:.1f} s, launches={launches} on {card}",
          flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched by the probes")
    return launches


#: kernels whose design step 2 has already redone (PERF.md §6 names when)
REDESIGNED = {"probe_mxu", "probe_dma_copy", "ntt_mxu", "ntt_mxu_chain", "ntt",
              "ntt_with_tables", "ntt_grid", "ks_head", "ks_tail", "aut", "probe_lane_stages",
              "probe_ops", "probe_mxu_parts", "probe_fwd_reps", "probe_stage_modes",
              "probe_dma_stages"}


def step2_order(kernels) -> list:
    """The kernels in the order a redesign should take them: first those
    slower than their one-call library equivalent, by the factor ms /
    library_ms (both eager: calls enqueued back to back between two CUDA
    events, as every kernel's ms); then the rest by the time the main paths
    lose to the bound, launches x (ms - bound_ms).  Kernels already
    redesigned (REDESIGNED) are marked."""
    lib = sorted((k for k in kernels if k["library_ms"] and k["ms"] > k["library_ms"]),
                 key=lambda k: -k["ms"] / k["library_ms"])
    rest = sorted((k for k in kernels if k not in lib),
                  key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"]))
    def done(k):
        return " (redesigned)" if k["name"] in REDESIGNED else ""

    return ([f"{k['name']} {k['ms'] / k['library_ms']:.2f}x library{done(k)}" for k in lib]
            + [f"{k['name']} {k['launches'] * (k['ms'] - k['bound_ms']):.3f} ms lost{done(k)}"
               for k in rest])


def main():
    card = phase_device()
    import torch

    try:
        clock = max_sm_clock_mhz()
        PEAK["int32"] = INT32_LANES * clock * 1e6
        print(f"bounds: HBM {HBM_BYTES_PER_S:.3g} B/s, int8 {PEAK['int8']:.4g} op/s, "
              f"INT32 issue {INT32_LANES} lanes x {clock:.0f} MHz (clocks.max.sm)", flush=True)
        t0 = time.perf_counter()
        (registers, ks_registers_, lane_registers_, ops_registers_, parts_registers_,
         stage_registers_, dma_registers_) = phase_build()
        dev = torch.device("cuda", 0)
        results = phase_kernels(card, dev)
        seconds = {"build+kernels": time.perf_counter() - t0}
        paths = {}
        for name, phase in (("serve", lambda: phase_serve(card, dev)),
                            ("bench", lambda: phase_bench(card, dev, results)),
                            ("shard", lambda: phase_shard(card, dev, results)),
                            ("multiply", lambda: phase_multiply(card, dev, results)),
                            ("isa", lambda: phase_isa(card, dev, results)),
                            ("probes", lambda: phase_probes(card, dev, results))):
            t0 = time.perf_counter()
            paths[name] = phase()
            seconds[name] = time.perf_counter() - t0
        print("phases: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
              flush=True)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail("a phase raised")

    from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG
    from aloha_tpu_torch.probes import common, dma_bisect, dma_bisect_stages

    nb, n, k = BENCH["batch"], CFG.n, BENCH["chain_k"]
    PROBE_NB, PROBE_REPS = common.SMALL
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
        "ntt_with_tables": ("aloha_tpu_torch/csrc/ntt.cu", "aloha_tpu/ops/ntt_stream.py:775",
                            None, f"fwd D=1 d=0 nb={SHARD_NB}"),
        "ntt_grid": ("aloha_tpu_torch/csrc/ntt.cu", "aloha_tpu/ops/ntt_pallas.py:378",
                     None, f"fwd q0 nb={GRID_NB} n={n}"),
        "aut": ("aloha_tpu_torch/csrc/aut.cu", "tools/probe_aut_kernel.py:102", None, AUT_MAIN),
        "probe_ops": ("aloha_tpu_torch/csrc/probe_ops.cu", "tools/op_probe.py:263", None,
                      f"v0 nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_fwd_reps": ("aloha_tpu_torch/csrc/probe_stages.cu", "tools/stream_prof3.py:29",
                           None, f"fwd nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_stage_modes": ("aloha_tpu_torch/csrc/probe_stages.cu", "tools/stream_prof.py:81",
                              None, f"full nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_lane_stages": ("aloha_tpu_torch/csrc/probe_stages.cu",
                              "tools/stream_prof2.py:64", None,
                              f"full-13 nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_mxu": ("aloha_tpu_torch/csrc/probe_mxu.cu", "tools/probe_mxu.py:58", None,
                      "rate nb=256 reps=1"),
        "probe_mxu_parts": ("aloha_tpu_torch/csrc/probe_mxu.cu", "tools/probe_mxu_parts.py:123",
                            None, f"full nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_dynstage": ("aloha_tpu_torch/csrc/probe_dyn.cu", "tools/probe_dynstage.py:38",
                           None, f"lanes nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_dynsub": ("aloha_tpu_torch/csrc/probe_dyn.cu", "tools/probe_dynsub.py:30", None,
                         f"rows nb={PROBE_NB} reps={PROBE_REPS}"),
        "probe_dma_copy": ("aloha_tpu_torch/csrc/probe_dma.cu", "tools/dma_bisect.py:34", None,
                           f"copy nb={dma_bisect.NBS[0]}"),
        "probe_dma_doublebuf": ("aloha_tpu_torch/csrc/probe_dma.cu",
                                "tools/dma_bisect_doublebuf.py:52", None,
                                f"roll-swap nb={dma_bisect.NBS[0]}"),
        "probe_dma_stages": ("aloha_tpu_torch/csrc/probe_dma.cu", "tools/dma_bisect_stages.py:81",
                             None, f"nstages=7 nb={dma_bisect_stages.NBS[0]}"),
        "probe_dma_tblread": ("aloha_tpu_torch/csrc/probe_dma.cu", "tools/dma_bisect_tblread.py:51",
                              None, f"table nb={dma_bisect.NBS[0]}"),
    }
    kernels = []
    for name, (src, repl, also, main_case) in meta.items():
        rows = results[name]
        _, _, k_us, p_us, b_us, b_by = next(r for r in rows if r[0] == main_case)
        by_path = {p: c[name] for p, c in paths.items() if name in c}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": repl,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": max(r[1] for r in rows),
                 "ms": k_us / 1e3, "plain_ms": p_us / 1e3,
                 "bound_ms": b_us / 1e3, "bound_by": b_by,
                 "library_ms": results.get("library", {}).get(name), "shape": main_case}
        if main_case in results.get("graph", {}).get(name, {}):
            entry["graph_ms"] = results["graph"][name][main_case]
            entry["library_graph_ms"] = results.get("library_graph", {}).get(name)
        if also:
            entry["also_replaces"] = also
        if name in results.get("marginal", {}):
            entry["marginal_ns"] = {k: v[0] for k, v in results["marginal"][name].items()}
            entry["bound_ns"] = {k: v[1] for k, v in results["marginal"][name].items()}
        if name == "ntt_grid":
            entry["timing"] = results["grid_timing"]
        if name == "aut":
            entry["timing"] = {k: {"graph_ms": v} for k, v in results["graph"]["aut"].items()}
        if name == "ntt":
            entry["isa_shape"] = results["isa_shape"]
            entry["registers"] = {k: v for k, v in registers.items() if "2^13 " in k}
        if name == "probe_lane_stages":
            entry["registers"] = lane_registers_
        if name == "probe_ops":
            entry["registers"] = ops_registers_
        if name == "probe_mxu_parts":
            entry["registers"] = parts_registers_
            entry["full_vs_chain_ns"] = results["parts_full_vs_chain_ns"]
        if name in ("probe_fwd_reps", "probe_stage_modes"):
            entry["registers"] = ({"full": stage_registers_["full"]} if name == "probe_fwd_reps"
                                  else stage_registers_)
            entry["ops_bound_ns"] = results["ops_bound_ns"][name]
        if name == "probe_fwd_reps":
            entry["full_vs_ntt_ns"] = results["fwd_reps_vs_ntt_ns"]
        if name == "probe_dma_stages":
            entry["registers"] = dma_registers_
        if name in ("ks_head", "ks_tail"):
            entry["timing"] = results["ks_timing"][name]
            entry["registers"] = {k: v for k, v in ks_registers_.items()
                                  if k.startswith(name[3:]) and "2^13 " in k}
        kernels.append(entry)
    print("step 2 order: " + ", ".join(step2_order(kernels)), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
