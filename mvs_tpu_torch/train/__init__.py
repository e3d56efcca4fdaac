"""MVSNet, CasMVSNet and CVP / AACVP-MVSNet training (counterpart of
mvs_tpu.train): losses, metrics, schedules, the optax-exact optimizer
chain, the MVSNet, cascade and pyramid tasks, the train step and
checkpoints."""
