"""``batching.pad_share.train``'s reading, for a cell whose end-to-end
metric is the peak memory, which the padded rows take as the real ones
do."""
from pathlib import Path

from perfbench.harness import load_file

read = load_file(Path(__file__).with_name("batching.pad_share.train.py")).read
