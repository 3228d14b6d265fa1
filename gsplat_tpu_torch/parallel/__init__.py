"""Multi-process rendering and training on torch.distributed (counterpart of
``gsplat_tpu.parallel``)."""
