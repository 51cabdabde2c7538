# coding: utf-8
"""
The recurrent encoder-decoder for text translation (counterpart of
joeys2t_tpu/models/rnn.py: ``init_stack_carry`` :20, ``_StackedCells`` :33,
``RecurrentEncoder`` :70, ``BahdanauAttention`` :158, ``LuongAttention``
:183, ``RecurrentDecoder`` :203).

Parameters carry the reference torch names, the flat ``nn.GRU``/``nn.LSTM``
tensors (``rnn.weight_ih_l{k}[_reverse]``, ``weight_hh``, ``bias_ih``,
``bias_hh``, gates stacked row-wise: GRU [r; z; n], LSTM [i; f; g; o]), so
joeys2t_tpu/convert.py splits them into the JAX package's per-gate cells.

The encoder runs cuDNN's RNN over packed sequences
(``pack_padded_sequence(enforce_sorted=False)``): a padded position outputs
zeros and leaves the state alone, so the final state is that of the last
valid position, as JAX's masked ``nn.scan`` gives it. A row of length 0,
which packing refuses, runs one position and is then zeroed, outputs and
state, as the JAX scan leaves it. The layers run one at a time, each as a
one-layer module on the stack's own parameters (``torch.func.functional_call``),
so the dropout between layers is the port's :class:`Dropout` on the
trainer's generator, as JAX applies it per layer, and never torch's global
generator (a multi-layer ``nn.GRU`` draws its inter-layer dropout there).
The decoder computes its cells by hand from the same flat tensors, one time
step a call, with the port's dropout between layers.

Biases: torch keeps two per gate where a flax cell keeps one (GRU: r and z
have ``bias_ih`` and ``bias_hh`` halves, JAX one each; LSTM: every gate has
both, JAX one), and JAX's converter sums each pair. The halves that flax
does not have (``bias_hh`` of GRU's r and z, all of LSTM's ``bias_hh``)
enter the computation detached: they add their value but take no gradient,
so the summed bias trains as JAX's single one does (each half would
otherwise take the full gradient, and an optimizer step would move the sum
twice). They are zero in a model the port initializes or converts from
JAX, and keep their value from a reference checkpoint.

Precision: everything here is float32 whatever the config's ``fp16`` says,
as in JAX, whose recurrent cells, attention and embeddings are built
without a compute dtype and whose recurrent searches take the parameters
uncast. On the card cuDNN's RNN would use TF32 by default; a float32 RNN
here runs with TF32 off.
"""
import contextlib
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from joeys2t_torch.models.encoders import lengths_to_mask
from joeys2t_torch.models.modules import NEG_INF, Dropout, build_activation

_RNN = {"gru": nn.GRU, "lstm": nn.LSTM}


def _check_type(rnn_type: str) -> str:
    if rnn_type not in _RNN:
        raise ValueError(f"Unknown rnn_type {rnn_type!r}. Valid options: 'gru', 'lstm'.")
    return rnn_type


def _no_tf32(x: torch.Tensor):
    """cuDNN without TF32 while a float32 tensor on the card goes through it."""
    if not x.is_cuda:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _bias_hh(rnn_type: str, bias: torch.Tensor) -> torch.Tensor:
    """``bias_hh`` as the cells compute with it: only GRU's n-gate third,
    which flax keeps as ``hn``, takes a gradient (see the module's
    docstring)."""
    if rnn_type == "lstm":
        return bias.detach()
    third = bias.shape[0] // 3
    return torch.cat([bias[:2 * third].detach(), bias[2 * third:]])


def _layer_params(rnn: nn.Module, rnn_type: str, layer: int, suffix: str = "") -> list:
    """(weight_ih, weight_hh, bias_ih, bias_hh) of ``rnn``'s layer ``layer``
    (direction ``suffix``) as the cells compute with them."""
    w_ih, w_hh, b_ih, b_hh = (getattr(rnn, f"{kind}_l{layer}{suffix}") for kind in
                              ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    return [w_ih, w_hh, b_ih, _bias_hh(rnn_type, b_hh)]


def init_stack_carry(rnn_type: str, num_layers: int, hidden_size: int, batch_size: int,
                     init_hidden: Optional[torch.Tensor] = None, device=None) -> Tuple:
    """Initial state of a cell stack: ``init_hidden`` (B, H) or zeros in every
    layer; an LSTM layer's state is (c, h), both from it (rnn.py:20-30)."""
    carry = []
    for _ in range(num_layers):
        h = (torch.zeros((batch_size, hidden_size), device=device)
             if init_hidden is None else init_hidden)
        carry.append((h, h) if rnn_type == "lstm" else h)
    return tuple(carry)


class RecurrentEncoder(nn.Module):
    """(Bi)directional multi-layer GRU/LSTM encoder (rnn.py:70-155): layer
    k > 0 reads both directions of layer k - 1, as torch's stacked RNN."""

    def __init__(self, rnn_type: str = "gru", hidden_size: int = 1, emb_size: int = 1,
                 num_layers: int = 1, dropout: float = 0.0, emb_dropout: float = 0.0,
                 bidirectional: bool = True, device=None):
        super().__init__()
        self.rnn_type = _check_type(rnn_type)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        self.dtype = torch.float32
        self.rnn = _RNN[rnn_type](emb_size, hidden_size, num_layers, batch_first=True,
                                  bidirectional=bidirectional, device=device)
        self.emb_dropout = Dropout(emb_dropout)
        self.layer_dropouts = nn.ModuleList(Dropout(dropout)
                                            for _ in range(max(num_layers - 1, 0)))
        # one-layer modules that run each layer on self.rnn's tensors; they
        # hold no parameters of their own and stay out of the module tree
        with torch.device("meta"):
            self._runners = tuple(
                _RNN[rnn_type](emb_size if k == 0 else self.output_size, hidden_size, 1,
                               batch_first=True, bidirectional=bidirectional)
                for k in range(num_layers))

    @property
    def output_size(self) -> int:
        return self.directions * self.hidden_size

    def forward(self, src_embed: torch.Tensor, src_length: torch.Tensor,
                mask: Optional[torch.Tensor] = None, src_prompt_embed=None):
        """(B, T, E) embedded tokens -> (output (B, T, dirs*H) with zeros at
        padded positions, the top layer's last valid states (B, dirs*H), mask
        (B, 1, T)). The source prompt is not read (rnn.py:128)."""
        del src_prompt_embed
        b, t, _ = src_embed.shape
        lengths = src_length.detach().cpu().long()  # packing reads them on the host
        if mask is None:
            mask = lengths_to_mask(src_length, t)
        nonempty = (lengths > 0).to(src_embed.device)
        x = self.emb_dropout(src_embed.float())
        h_n = None
        for k, runner in enumerate(self._runners):
            packed = pack_padded_sequence(x, lengths.clamp(min=1), batch_first=True,
                                          enforce_sorted=False)
            params = {f"{kind}_l0{suffix}": value
                      for suffix in ("", "_reverse")[:self.directions]
                      for kind, value in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                                             _layer_params(self.rnn, self.rnn_type, k,
                                                           suffix))}
            with _no_tf32(x), warnings.catch_warnings():
                # the detached bias halves are new tensors: cuDNN copies this
                # layer's weights into one buffer a call (a few kB), and says so
                warnings.filterwarnings("ignore", "RNN module weights are not part")
                out, state = functional_call(runner, params, (packed,))
            x, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
            x = x * nonempty[:, None, None]
            h_n = state[0] if self.rnn_type == "lstm" else state  # (dirs, B, H)
            if k < self.num_layers - 1:
                x = self.layer_dropouts[k](x)
        hidden = torch.cat(list(h_n), dim=-1) * nonempty[:, None]
        return x, hidden, mask


class BahdanauAttention(nn.Module):
    """MLP attention (rnn.py:158-180)."""

    def __init__(self, hidden_size: int, key_size: int, query_size: int, device=None):
        super().__init__()
        self.key_layer = nn.Linear(key_size, hidden_size, bias=False, device=device)
        self.query_layer = nn.Linear(query_size, hidden_size, bias=False, device=device)
        self.energy_layer = nn.Linear(hidden_size, 1, bias=False, device=device)

    def project_keys(self, keys: torch.Tensor) -> torch.Tensor:
        return self.key_layer(keys)

    def forward(self, query, proj_keys, values, mask):
        """query (B, 1, Dq), proj_keys (B, S, H), values (B, S, Dv), mask (B,
        1, S) -> (context (B, 1, Dv), weights (B, 1, S))."""
        scores = self.energy_layer(torch.tanh(self.query_layer(query) + proj_keys))
        scores = scores.transpose(1, 2).masked_fill(~mask, NEG_INF)
        alphas = torch.softmax(scores, dim=-1)
        return alphas @ values, alphas


class LuongAttention(nn.Module):
    """Bilinear attention (rnn.py:183-200)."""

    def __init__(self, hidden_size: int, key_size: int, device=None):
        super().__init__()
        self.key_layer = nn.Linear(key_size, hidden_size, bias=False, device=device)

    def project_keys(self, keys: torch.Tensor) -> torch.Tensor:
        return self.key_layer(keys)

    def forward(self, query, proj_keys, values, mask):
        scores = (query @ proj_keys.transpose(1, 2)).masked_fill(~mask, NEG_INF)
        alphas = torch.softmax(scores, dim=-1)
        return alphas @ values, alphas


def _cell(rnn_type: str, x: torch.Tensor, state, w_ih, w_hh, b_ih, b_hh):
    """One GRU or LSTM step on torch's flat tensors (the flax cells' math)."""
    gi = F.linear(x, w_ih, b_ih)
    h = state[1] if rnn_type == "lstm" else state
    gh = F.linear(h, w_hh, b_hh)
    if rnn_type == "gru":
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r, z = torch.sigmoid(i_r + h_r), torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h
    i, f, g, o = (gi + gh).chunk(4, dim=-1)
    c = torch.sigmoid(f) * state[0] + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(c)
    return (c, new_h), new_h


class RecurrentDecoder(nn.Module):
    """Conditional GRU/LSTM decoder with attention (rnn.py:203-305): a full
    teacher-forced unroll for training and ``step`` for search, carrying
    (state, attentional vector)."""

    def __init__(self, rnn_type: str = "gru", emb_size: int = 0, hidden_size: int = 0,
                 encoder_output_size: int = 0, attention: str = "bahdanau",
                 num_layers: int = 1, vocab_size: int = 0, dropout: float = 0.0,
                 emb_dropout: float = 0.0, hidden_dropout: float = 0.0,
                 init_hidden: str = "bridge", input_feeding: bool = True,
                 activation: str = "tanh", encoder_hidden_size: Optional[int] = None,
                 device=None):
        super().__init__()
        self.rnn_type = _check_type(rnn_type)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.input_feeding = input_feeding
        self.init_hidden_option = init_hidden
        self.dtype = torch.float32
        rnn_input = emb_size + hidden_size if input_feeding else emb_size
        # a holder of the flat per-layer tensors; _cell computes with them
        self.rnn = _RNN[rnn_type](rnn_input, hidden_size, num_layers, batch_first=True,
                                  device=device)
        self.layer_dropouts = nn.ModuleList(Dropout(dropout)
                                            for _ in range(max(num_layers - 1, 0)))
        self.att_vector_layer = nn.Linear(hidden_size + encoder_output_size, hidden_size,
                                          device=device)
        self.output_layer = nn.Linear(hidden_size, vocab_size, bias=False, device=device)
        if attention == "bahdanau":
            self.attention = BahdanauAttention(hidden_size, encoder_output_size,
                                               hidden_size, device)
        elif attention == "luong":
            self.attention = LuongAttention(hidden_size, encoder_output_size, device)
        else:
            raise ValueError(f"Unknown attention mechanism: {attention}. "
                             "Valid options: 'bahdanau', 'luong'.")
        # JAX makes the bridge only where it is called: over a recurrent
        # encoder's states (a transformer encoder has none)
        self.bridge_layer = (nn.Linear(encoder_hidden_size, hidden_size, device=device)
                             if init_hidden == "bridge" and encoder_hidden_size else None)
        self.emb_dropout = Dropout(emb_dropout)
        self.hidden_dropout = Dropout(hidden_dropout)
        self.act = build_activation(activation)

    @property
    def output_size(self) -> int:
        return self.output_layer.out_features

    def init_hidden(self, encoder_hidden: Optional[torch.Tensor], batch_size: int,
                    device=None) -> Tuple:
        """The first state (rnn.py:252-261): the bridge's, the encoder's last
        states cut to H, or zeros."""
        h = None
        if self.bridge_layer is not None and encoder_hidden is not None:
            h = self.act(self.bridge_layer(encoder_hidden))
        elif self.init_hidden_option == "last" and encoder_hidden is not None:
            h = encoder_hidden[:, :self.hidden_size]
        return init_stack_carry(self.rnn_type, self.num_layers, self.hidden_size,
                                batch_size, h, device)

    def init_state(self, encoder_output: torch.Tensor,
                   encoder_hidden: Optional[torch.Tensor]):
        """(state, zero attentional vector (B, 1, H), projected keys) before
        the first step."""
        b, device = encoder_output.shape[0], encoder_output.device
        return (self.init_hidden(encoder_hidden, b, device),
                torch.zeros((b, 1, self.hidden_size), device=device),
                self.attention.project_keys(encoder_output))

    def _stack(self, carry: Sequence, x: torch.Tensor):
        """The cell stack on one step's input (B, D) -> (new state, top output)."""
        new_carry: List = []
        for k in range(self.num_layers):
            state, x = _cell(self.rnn_type, x, carry[k],
                             *_layer_params(self.rnn, self.rnn_type, k))
            new_carry.append(state)
            if k < self.num_layers - 1:
                x = self.layer_dropouts[k](x)
        return tuple(new_carry), x

    def step(self, prev_embed: torch.Tensor, prev_att_vector: torch.Tensor, carry,
             proj_keys: torch.Tensor, encoder_output: torch.Tensor,
             src_mask: torch.Tensor):
        """One step (rnn.py:263-278): (prev embedding (B, 1, E), previous
        attentional vector (B, 1, H), state) -> (attentional vector (B, 1,
        H), state, attention weights (B, 1, S)). The embedding dropout acts
        on the input after input feeding, as JAX applies it."""
        rnn_input = (torch.cat([prev_embed, prev_att_vector], dim=2)
                     if self.input_feeding else prev_embed)
        rnn_input = self.emb_dropout(rnn_input)
        carry, top = self._stack(carry, rnn_input[:, 0])
        query = top[:, None, :]
        context, att_probs = self.attention(query, proj_keys, encoder_output, src_mask)
        att_input = self.hidden_dropout(torch.cat([query, context], dim=2))
        return self.act(self.att_vector_layer(att_input)), carry, att_probs

    def forward(self, trg_embed: torch.Tensor, encoder_output: torch.Tensor,
                encoder_hidden: Optional[torch.Tensor], src_mask: torch.Tensor):
        """Teacher-forced unroll over trg_embed's (B, T, E) steps (rnn.py:
        283-305) -> (logits (B, T, V), last state, attentional vectors (B, T,
        H))."""
        encoder_output = encoder_output.float()
        carry, att_vector, proj_keys = self.init_state(encoder_output, encoder_hidden)
        vectors = []
        for i in range(trg_embed.shape[1]):
            att_vector, carry, _ = self.step(trg_embed[:, i:i + 1], att_vector, carry,
                                             proj_keys, encoder_output, src_mask)
            vectors.append(att_vector)
        vectors = torch.cat(vectors, dim=1)
        return self.output_layer(vectors), carry, vectors
