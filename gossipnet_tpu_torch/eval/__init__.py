from gossipnet_tpu_torch.eval.cocoeval import COCOEvaluator, EvalImage  # noqa: F401
