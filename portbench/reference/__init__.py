"""Plain references of the benchmark's configurations (plain PyTorch; no
import of the program under test)."""
