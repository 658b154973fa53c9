"""Plain PyTorch references: they import nothing of the program and work
out everything they compare again from the generated inputs."""
