"""The HE vector ISA: instruction encoding, the four canned programs, the replayer."""
