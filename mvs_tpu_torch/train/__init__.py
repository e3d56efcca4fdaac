"""CasMVSNet training (counterpart of mvs_tpu.train): losses, metrics,
schedules, the optax-exact optimizer chain, the cascade task, the train
step and checkpoints."""
