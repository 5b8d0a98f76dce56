"""Command-line tools of the port (``python -m mxnet_tpu_torch.tools.<name>``):
``elastic_launch``, the elastic supervisor."""
