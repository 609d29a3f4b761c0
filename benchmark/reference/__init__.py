"""The benchmark's plain reference: the sequencer, its train steps and its
sort evaluation in plain PyTorch and NumPy, float32, for judging what the
program's timed path produced. It imports nothing of the program."""
