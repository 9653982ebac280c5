"""Data parallelism over cards: one process a card in a torch.distributed
process group (parallel/mesh.py)."""
