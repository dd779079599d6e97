from difformer_tpu_torch.nn.difformer import DIFFormer, DIFFormerConv  # noqa: F401
