"""MVSNet and CasMVSNet training (counterpart of mvs_tpu.train): losses,
metrics, schedules, the optax-exact optimizer chain, the MVSNet and cascade
tasks, the train step and checkpoints."""
