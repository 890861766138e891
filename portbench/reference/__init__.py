"""Plain PyTorch references of the benchmarked models: frozen copies of
the port's architectures with every hand kernel replaced by its plain
version, computed in float32 (TF32 off). They import nothing of the
program and take nothing it made: the benchmark makes the weights and
the frames and hands the same to both sides."""
