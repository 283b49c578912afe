from repro_torch.data.pipeline import BatchSpec, SyntheticLM, MemmapCorpus, batch_spec_for, global_batch  # noqa: F401
