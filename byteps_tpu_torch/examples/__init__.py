"""Native examples of the port: the counterparts of ``example/torch/*`` on
``byteps_tpu_torch.torch``.  Each has ``main(argv)`` and runs as
``python -m byteps_tpu_torch.examples.<name>``, on CUDA unless given
``--device cpu``."""
