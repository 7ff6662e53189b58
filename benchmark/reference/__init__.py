"""The plain reference: forward kinematics, the fitness, the accuracy
summaries and a plain PSO, in plain PyTorch at any float dtype; the
frozen operation and byte counts of the kernels; the comparison that
decides ``correct``. Nothing here imports ``ikpso_tpu_torch``, JAX or
the JAX package, and nothing takes what the program made: the model
comes from the configuration's numbers."""
