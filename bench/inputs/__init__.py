"""Batch generators, one module per modality (the configuration file's
``modality``): ``make_batch(conf, batch, seq, seed, step, device)`` makes
one training step's batch on ``device`` from the run's seed and the step,
in the layout ``repro_torch.models.lm.StagedLM.loss_fn`` takes."""
