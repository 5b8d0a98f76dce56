"""Not ported yet: the bucketed gradient all-reduce and the sharded
update of ``mxnet_tpu/parallel/fusion.py`` arrive with the next parallel
slice, with training under a mesh."""

raise NotImplementedError("mxnet_tpu_torch.parallel.fusion (the bucketed "
                          "all-reduce) arrives with the next parallel slice")
