"""Multi-GPU runs over ``torch.distributed``, one process per rank: the
SNP-sharded scan and the sample-sharded eigendecomposition (``mesh`` builds
the rank layout, ``distributed`` starts the group and moves the replicated
inputs and the table, ``dist`` holds the per-rank pieces of the scan and
``sharded_eigh_fn``, ``slabs`` the row-slabbed products that eigh_dc runs
on the ``sample`` ranks)."""
