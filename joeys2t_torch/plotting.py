# coding: utf-8
"""
Attention plots (counterpart of joeys2t_tpu/plotting.py: ``plot_heatmap``
:14, ``store_attention_plots`` :56).

matplotlib is an optional dependency, imported inside the functions with
the ``Agg`` backend, as in JAX. A text source labels its rows with its
tokens, as JAX does. A speech source (a (frames, features) array) labels
its rows with the indices of the subsampled frames the decoder attended
over, cut after the last frame any target step attends to (the padding
frames take exactly 0); JAX hands the feature rows themselves to
matplotlib there, whose error it catches, and writes no plot.
"""
import importlib.util
from typing import List, Optional

import numpy as np

from joeys2t_torch.utils.logging import get_logger

logger = get_logger(__name__)


def plot_heatmap(scores: np.ndarray, column_labels: List[str], row_labels: List[str],
                 output_path: Optional[str] = None, dpi: int = 300):
    """A (src x trg) attention heatmap written to png or pdf (``output_path``),
    or the figure itself."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    x_sc, y_sc = 0.5, 0.8
    font_size = 8
    fig, ax = plt.subplots(figsize=(x_sc * len(column_labels), y_sc * len(row_labels)))
    plt.imshow(scores, cmap="viridis", aspect="auto", origin="upper", vmin=0.0, vmax=1.0)
    ax.xaxis.tick_top()
    ax.set_xticks(np.arange(scores.shape[1]) + 0, minor=False)
    ax.set_yticks(np.arange(scores.shape[0]) + 0, minor=False)
    ax.set_xticklabels(column_labels, minor=False, rotation="vertical", fontsize=font_size)
    ax.set_yticklabels(row_labels, minor=False, fontsize=font_size)
    plt.tight_layout()
    if output_path is not None:
        if output_path.endswith(".pdf"):
            pp = PdfPages(output_path)
            pp.savefig(fig)
            pp.close()
        else:
            if not output_path.endswith(".png"):
                output_path += ".png"
            plt.savefig(output_path)
        plt.close(fig)
    return fig


def _source_labels(src, attention_scores: np.ndarray) -> List[str]:
    """Row labels: a text source's tokens, or a speech source's subsampled
    frame indices up to the last frame with any attention."""
    if isinstance(src, np.ndarray):
        attended = np.flatnonzero(attention_scores.any(axis=1))
        return [str(i) for i in range(attended[-1] + 1 if attended.size else 0)]
    return src


def store_attention_plots(attentions, targets: List[List[str]], sources: List,
                          output_prefix: str, indices: List[int], tb_writer=None,
                          steps: int = 0) -> List[str]:
    """Plot the attention of the examples ``indices`` to
    ``<output_prefix>.<i>.png`` (and to the TensorBoard writer); returns the
    files written. A plot that fails is skipped with a warning, as in JAX;
    without matplotlib one warning says that none was written."""
    written = []
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: no attention plots written to %s",
                       output_prefix)
        return written
    for i in indices:
        if i >= len(sources):
            continue
        plot_file = f"{output_prefix}.{i}.png"
        trg = targets[i]
        attention_scores = np.asarray(attentions[i]).T
        src = _source_labels(sources[i], attention_scores)
        # decode buffers are padded (bucketed frames, max decode steps): trim
        # to the labelled lengths
        attention_scores = attention_scores[:len(src), :len(trg)]
        try:
            plot_heatmap(scores=attention_scores, column_labels=trg, row_labels=src,
                         output_path=plot_file, dpi=100)
            written.append(plot_file)
            if tb_writer is not None:
                fig = plot_heatmap(scores=attention_scores, column_labels=trg,
                                   row_labels=src, output_path=None, dpi=50)
                tb_writer.add_figure(f"attention/{i}.", fig, global_step=steps)
        except Exception:  # pylint: disable=broad-except
            logger.warning("Couldn't plot example %d: src len %d, trg len %d, attention "
                           "scores shape %s", i, len(src), len(trg), attention_scores.shape)
    return written
