"""Several devices: process-group bring-up and the collective counter
(`multihost`), the coefficient-sharded NTT (`ntt_sharded`), the
digit-sharded rotation (`keyswitch_sharded`), the coefficient-sharded
rotation (`coeff_sharded`) and their dry run (`dryrun`)."""
