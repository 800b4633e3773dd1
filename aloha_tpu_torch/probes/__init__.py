"""Cost probes on the card: the port of the `tools/` scripts that probe the TPU kernels.

The step probes run REPS data-dependent repetitions of one step of a
kernel on resident data (in registers or shared memory) and report the
marginal time per polynomial (or block) per repetition (`common.marginal`):

- `op_probe`: the building blocks, 15 variants (tools/op_probe.py);
- `stream_prof3`: whole forward transforms, csrc/ntt.cu's own
  (tools/stream_prof3.py);
- `stream_prof`: the 13-stage loop, full / exchange-and-add / no exchange
  (tools/stream_prof.py); `stage_modes_timing` times its three modes beside
  csrc/ntt.cu's forward marginal, also on another checkout;
- `stream_prof2`: lane stages, full / fixed table row / fixed distance /
  no butterfly (tools/stream_prof2.py);
- `probe_mxu`, `probe_mxu_parts`: the int8 tensor-core rate and the split
  of the tensor-core transform, on its own device code (tools/probe_mxu.py,
  probe_mxu_parts.py);
- `probe_dynstage`, `probe_dynsub`: stage loops under a runtime index
  (tools/probe_dynstage.py, probe_dynsub.py).

The copy pipelines move blocks between device memory and shared memory by
bulk asynchronous copies and report the marginal time per block (or
polynomial) over the batch (`common.batch_marginal`) beside the HBM rate:

- `dma_bisect`: one slot, synchronous, copy or x*3 + 1 (tools/dma_bisect.py);
- `dma_bisect_doublebuf`: two slots, roll, row-pair swap, x*3 + 1
  (tools/dma_bisect_doublebuf.py);
- `dma_bisect_tblread`: two slots, x + the sum of 13 table rows
  (tools/dma_bisect_tblread.py);
- `dma_bisect_stages`: two slots, NSTAGES forward lane stages of the NTT
  (tools/dma_bisect_stages.py).

    python -m aloha_tpu_torch.probes.<module> [variants or modes]

needs an NVIDIA GPU and exits nonzero without one.  On CPU tensors each
wrapper runs its plain PyTorch version (the tests use it).
"""
