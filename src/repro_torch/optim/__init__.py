from repro_torch.optim.adamw import AdamW, AdamWState, abstract_state, apply_updates, warmup_cosine, global_norm  # noqa: F401
