"""Not ported yet: the elastic membership and resharding of
``mxnet_tpu/parallel/elastic.py`` arrive with the next parallel slice."""

raise NotImplementedError("mxnet_tpu_torch.parallel.elastic arrives with "
                          "the next parallel slice")
