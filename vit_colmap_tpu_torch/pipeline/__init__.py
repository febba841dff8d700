from vit_colmap_tpu_torch.pipeline.run_pipeline import Pipeline, main

__all__ = ["Pipeline", "main"]
