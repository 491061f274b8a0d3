"""Data-parallel training (port of heterofusionrcnn_tpu/parallel): one
process a rank in a `torch.distributed` group (`distributed`), and the
collectives that give a step of W ranks the arithmetic of one process on
the global batch (`mesh`)."""
