"""The benchmark's plain reference: float32 PyTorch with TF32 off, written
from the published model and serving semantics. It imports nothing of the
program under test and takes nothing the program made."""
