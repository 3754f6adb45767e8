"""The benchmark's plain reference: NumPy and plain PyTorch only.

It imports nothing of the program under test and takes nothing it made:
from the reads that the benchmark generated it works out the text, the
multi-string BWT and its counts, decodes the program's `.fmd` files with
its own frozen copy of the RLD\\2 decoder, and searches SMEMs with a plain
sequential copy of fermi's fm6_smem.
"""
