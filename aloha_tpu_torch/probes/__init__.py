"""Cost probes of the NTT kernels on the card: the port of four `tools/` scripts.

Each module runs REPS data-dependent repetitions of one step of
`csrc/ntt.cu`'s forward transform on polynomials held in shared memory,
and reports the marginal time per polynomial per repetition
(`common.marginal_ns`):

- `op_probe`: the building blocks, 15 variants (tools/op_probe.py);
- `stream_prof3`: whole forward transforms (tools/stream_prof3.py);
- `stream_prof`: the 13-stage loop, full / exchange-and-add / no exchange
  (tools/stream_prof.py);
- `stream_prof2`: lane stages, full / fixed table row / fixed distance /
  no butterfly (tools/stream_prof2.py).

    python -m aloha_tpu_torch.probes.<module> [variants or modes]

needs an NVIDIA GPU and exits nonzero without one.  On CPU tensors each
wrapper runs its plain PyTorch version (the tests use it).
"""
