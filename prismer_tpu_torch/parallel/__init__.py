"""Several ranks, one process each: the mesh and placement rules (mesh),
the process runtime (runtime), data-parallel / ZeRO-2 / ZeRO-3 train
state (zero), tensor parallelism (tp) and the multi-rank dry run
(dryrun). Ported from prismer_tpu/parallel/ and __graft_entry__.py."""
