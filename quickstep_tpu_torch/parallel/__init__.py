"""The mesh path: a mesh of row shards, the radix shuffle and the
distributed aggregate step (counterparts of quickstep_tpu/parallel/)."""
