"""The benchmark's harness: one cell's run, from the data files that
``BENCHMARK.json`` names to the result line."""
import os

#: the root of the checkout the benchmark runs from
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the benchmark's own build and cache directories (git-ignored)
BUILD_DIR = os.path.join(ROOT, "portbench", "_build")
