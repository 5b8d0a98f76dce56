"""Not ported yet: the pipeline stages and microbatch schedule of
``mxnet_tpu/parallel/pipeline.py`` arrive with the next parallel slice."""

raise NotImplementedError("mxnet_tpu_torch.parallel.pipeline (pipeline "
                          "stages) arrives with the next parallel slice")
