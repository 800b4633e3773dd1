"""The system's side of each request kind: what set-up prepares and the chain
of `aloha_tpu_torch.he_torch` calls that the measured window drives.  Each
kind's inputs, reference and cleartext result are in `portbench.reference`
under the same name."""
