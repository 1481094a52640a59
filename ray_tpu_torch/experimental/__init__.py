"""ray_tpu_torch.experimental — compiled-DAG channels and other pre-stable APIs."""
