"""Plain float32 PyTorch references of the benchmark's model families.

Nothing here imports the program (kungfu_tpu_torch) or JAX. Each module
makes the weights of its family from a seed (the benchmark hands the same
draw to the program) and replays the first training steps in float32 with
TF32 off, or, for the control, with the bf16 matrix products rounded to
fp8 and the float32 head to bf16.
"""
