"""What the benchmark's tests share: the paths, and a cell shrunk to a size
the CPU runs in seconds."""
import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for _path in (str(HERE.parent), str(HERE)):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def shrink(cell):
    """The cell at a size the CPU runs in seconds: 2 + 2 layers of width 64,
    60 ids, a few short utterances or sentences."""
    cell = copy.deepcopy(cell)
    m = cell.config["model"]
    m["encoder"].update(num_layers=2, hidden_size=64, ff_size=128)
    if "conv_channels" in m["encoder"]:
        m["encoder"]["conv_channels"] = 64
    else:
        m["encoder"]["embeddings"]["embedding_dim"] = 64
    m["decoder"].update(num_layers=2, hidden_size=64, ff_size=128)
    m["decoder"]["embeddings"]["embedding_dim"] = 64
    cell.config["vocab_size"] = 60
    t = cell.traffic
    if t["kind"] == "train":
        t.update(pool_batches=3, check_updates=3, trace_units=2)
        t["utterance_seconds"].update(mean=3.0, sd=1.0, min=1.0, max=5.0)
        cell.config["training"].update(batch_size=3000, learning_rate=2e-3,
                                       learning_rate_warmup=10)
    elif t["kind"] == "transcribe":
        t.update(utterances=20, check_sample=4, trace_units=2)
        t["utterance_seconds"].update(mean=2.0, min=1.3, max=3.0)
        cell.config["testing"].update(batch_size=8, max_output_length=10)
    else:
        t.update(sentences=12, check_sample=4)
        t["source_ids"].update(mean=8, min=2, max=15)
        cell.config["testing"].update(batch_size=6, max_output_length=10, beam_size=3)
    return cell
