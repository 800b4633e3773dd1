"""Several devices: process-group bring-up (`multihost`), the coefficient-
sharded NTT (`ntt_sharded`) and its dry run (`dryrun`)."""
