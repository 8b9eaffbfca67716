"""Multi-GPU runs: the SNP-sharded scan over ``torch.distributed``, one
process per rank (``mesh`` builds the rank layout, ``distributed`` starts
the group and moves the replicated inputs and the table, ``dist`` holds the
per-rank pieces of the scan)."""
