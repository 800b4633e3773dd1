#!/usr/bin/env python
"""End-to-end encrypted matrix-vector product on the PyTorch/CUDA port.

    python examples/encrypted_matvec_torch.py               # on the card
    python examples/encrypted_matvec_torch.py --device cpu  # plain PyTorch
    python examples/encrypted_matvec_torch.py --seed 7      # reproducible keys

The port of examples/encrypted_matvec.py with `aloha_tpu_torch` alone: a
bank of D = 4 wrapped diagonals applied to an encrypted vector by the
diagonal method with baby-step/giant-step (g = 2: one hoisted baby
rotation, one giant rotation).  Pipeline: encode -> encrypt -> matvec_bsgs
-> rescale -> decrypt -> decode, checked against the cleartext product
(the client's side through `aloha_tpu_torch.client`).  The secret key,
the rotation keys and the encryption draw from the OS, as the JAX
example's do; `--seed` draws them from a seeded `torch.Generator`
instead, for a run that repeats word for word.  On `cuda` the
transforms and the key-switch run the hand kernels (csrc/ntt.cu,
csrc/ks.cu); on the CPU their plain versions.  Prints the slot error and
exits nonzero unless it is below 0.15 and within the rescale's noise
bound; without a CUDA device it exits nonzero unless `--device cpu` is
given.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from aloha_tpu_torch import client, encoder, keys
from aloha_tpu_torch import convert as cv
from aloha_tpu_torch import he_torch as ht
from aloha_tpu_torch.config import DEFAULT_CONFIG as CFG

ENVELOPE = 0.15  # decrypt error bound of the rescale path at this parameterisation
D, G = 4, 2  # diagonals, baby-step count (g b >= D)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="draw keys and encryption from a generator of this seed (default: the OS)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("encrypted_matvec_torch: no CUDA device (pass --device cpu for the plain path)",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    rng = np.random.default_rng(7)  # the public data: the vector and the diagonals
    gen = None if args.seed is None else torch.Generator().manual_seed(args.seed)
    S = CFG.n // 2  # complex slots

    # -- keys
    sk = keys.gen_secret(CFG, gen, dev)
    ksks_baby = [keys.gen_rotation_key(sk, j, CFG, gen) for j in range(1, G)]
    ksks_giant = [keys.gen_rotation_key(sk, G * i, CFG, gen) for i in range(1, (D + G - 1) // G)]

    # -- encrypt the vector
    z = rng.uniform(-1, 1, size=S) + 1j * rng.uniform(-1, 1, size=S)
    ct = client.encrypt_slots(z[None], sk, CFG, gen)

    # -- encode the matrix diagonals (public data)
    dvecs = [rng.uniform(-1, 1, size=S) for _ in range(D)]
    diags = ht.encode_post(cv.from_u64(np.stack(
        [encoder.encode(encoder.cleartext_from_slots(d + 0j), CFG) for d in dvecs]), dev), CFG)

    # -- encrypted matvec: g-1 hoisted baby and b-1 giant rotations (not D-1)
    out = ht.rescale(ht.matvec_bsgs(ct, list(diags), ksks_baby, ksks_giant, CFG, g=G), CFG)

    # -- decrypt + decode at the post-rescale scale Delta^2/q1
    got, dec = client.decrypt_rescaled(out, sk, CFG)
    err, ratio, _ = client.slot_errors(got, client.matvec_clear(dvecs, z)[None],
                                    client.noise_sigma(dec, sk, CFG))
    err, bound = float(err[0]), client.noise_bound(S)
    source = "the OS" if args.seed is None else f"seed {args.seed}"
    print(f"slots checked: {S} on {dev}, keys from {source}; max |error| = {err:.4f} (envelope {ENVELOPE}), "
          f"{ratio:.3f} noise standard deviations (bound {bound:.3f})")
    if not (err < ENVELOPE and ratio < bound):
        print("encrypted matvec FAILED", file=sys.stderr)
        return 1
    print("encrypted matvec OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
