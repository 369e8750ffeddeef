"""The port's operators: the kernel wrappers and their plain versions."""
