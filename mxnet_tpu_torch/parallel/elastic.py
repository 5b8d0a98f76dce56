"""Not ported yet: the elastic membership and resharding of
``mxnet_tpu/parallel/elastic.py`` arrive with ROADMAP item A7d."""

raise NotImplementedError("mxnet_tpu_torch.parallel.elastic waits for "
                          "ROADMAP item A7d (elastic worlds and the shard "
                          "checkpoints)")
