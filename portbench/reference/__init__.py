"""The benchmark's plain reference: RNS-CKKS written from its definitions.

Plain PyTorch and NumPy on int64 tensors, on whatever device the caller
names.  It imports nothing of the system under test, of JAX or of the JAX
package, and takes nothing the system made: from the benchmark's draws it
derives its own twiddle tables, secret key, key-switch keys, encodings and
encryptions, and it reads the system's outputs only to judge them.
"""
