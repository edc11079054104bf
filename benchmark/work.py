"""The benchmark's yardstick of work: operations and bytes of each layer,
computed from the shapes a run drove, and the published peaks of each
card.

Every count is the least work the layer's result needs, whatever kernels
compute it: each input byte read once, each output byte written once,
and the recurrent steps of each row counted at its own length (a padded
step does no useful work). A share of a roofline is the least time the
card could take, the larger of operations over peak operations a second
and bytes over peak bytes a second, divided by the measured device time.

The tower counts follow the cells of the port (``sse_tpu_torch/ops/rnn.py``):
a GRU step multiplies [x; h] by a fused [(E+H), 3H] weight, an LSTM step
by a [(E+H), 4H] one. An earlier count (``sse_tpu_torch/bench.py``
``_tower_flops``) charged every tower a 3-gate cell and left out the
attention readout; ``legacy_tower_flops`` keeps it for the tests that
show the difference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

# Published dense peaks (bf16 TFLOP/s, HBM GB/s) keyed by a prefix of
# torch.cuda.get_device_name(); the longest matching prefix wins. NVIDIA's
# data sheets, without sparsity; the SXM part at its full 700 W.
CHIP_SPECS = (
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),  # SXM
    ("NVIDIA H100 PCIe", (756.0, 2000.0)),
    ("NVIDIA H100 NVL", (835.0, 3900.0)),
)

BF16 = 2
F32 = 4
I32 = 4

GATES = {"gru": 3, "lstm": 4}


def chip_spec(kind: Optional[str]) -> Optional[Tuple[float, float]]:
    """(peak bf16 TFLOP/s, HBM GB/s) of the card named ``kind``, or None."""
    match = None
    for prefix, spec in CHIP_SPECS:
        if kind and kind.startswith(prefix) and (match is None or len(prefix) > len(match[0])):
            match = (prefix, spec)
    return None if match is None else match[1]


def bound_seconds(flops: float, nbytes: float, kind: Optional[str]) -> Optional[float]:
    """The least seconds the card ``kind`` needs for the work: the larger
    of its operations at the peak rate and its bytes at the HBM rate."""
    spec = chip_spec(kind)
    if spec is None:
        return None
    tflops, gbps = spec
    return max(flops / (tflops * 1e12), nbytes / (gbps * 1e9))


def peak_flops(kind: Optional[str]) -> Optional[float]:
    spec = chip_spec(kind)
    return None if spec is None else spec[0] * 1e12


# ------------------------------------------------------------------ towers
def rnn_layer_fwd(cell: str, tokens: int, rows: int, embed: int, hidden: int,
                  ) -> Dict[str, float]:
    """One recurrent layer forward over ``rows`` sequences holding
    ``tokens`` valid steps in all: per step the [x; h]·W product (2 (E+H)
    G·H operations); bytes: the bf16 inputs and outputs of the valid
    steps, the fused weight and bias once, the final state of each row."""
    g = GATES[cell]
    flops = 2.0 * tokens * (embed + hidden) * g * hidden
    nbytes = (tokens * embed * BF16 + tokens * hidden * BF16
              + (embed + hidden) * g * hidden * F32 + g * hidden * F32
              + rows * hidden * F32)
    return {"flops": flops, "bytes": nbytes}


def rnn_layer_bwd(cell: str, tokens: int, rows: int, embed: int, hidden: int,
                  ) -> Dict[str, float]:
    """One recurrent layer backward: the input and weight gradients, two
    products of the forward's size (4 (E+H) G·H operations a step); bytes:
    the saved inputs and states and the incoming gradient read once, the
    input gradient and the weight gradient written once."""
    g = GATES[cell]
    flops = 4.0 * tokens * (embed + hidden) * g * hidden
    saved = tokens * (embed + hidden) * BF16 * (2 if cell == "lstm" else 1)
    nbytes = (saved + tokens * hidden * BF16 + tokens * embed * BF16
              + (embed + hidden) * g * hidden * F32 * 2 + rows * hidden * F32)
    return {"flops": flops, "bytes": nbytes}


def readout_fwd(readout: str, tokens: int, rows: int, hidden: int) -> float:
    """Operations of the readout: the attention readout's W·h_t, v·tanh(.)
    and weighted sum a valid step; none for the final state."""
    if readout == "attention":
        return tokens * (2.0 * hidden * hidden + 4.0 * hidden)
    if readout == "mean":
        return tokens * 1.0 * hidden
    return 0.0


def tower_fwd_flops(cell: str, readout: str, tokens: int, rows: int, embed: int,
                    hidden: int, dim: int, layers: int = 1) -> float:
    """Model operations of one tower forward: the recurrent layers, the
    readout and the tanh projection."""
    rnn = rnn_layer_fwd(cell, tokens, rows, embed, hidden)["flops"]
    if layers > 1:
        rnn += (layers - 1) * rnn_layer_fwd(cell, tokens, rows, hidden, hidden)["flops"]
    return rnn + readout_fwd(readout, tokens, rows, hidden) + 2.0 * rows * hidden * dim


def legacy_tower_flops(rows: int, length: int, embed: int, hidden: int, dim: int,
                       layers: int = 1) -> float:
    """The earlier bench's count (3 gates whatever the cell, no readout),
    kept to show the difference in tests."""
    return (rows * length * 2 * layers * (embed * 3 * hidden + hidden * 3 * hidden)
            + rows * 2 * hidden * dim)


# ------------------------------------------------------------------ top-k
def score_topk(batch: int, rows: int, dim: int, k: int, row_bytes: int) -> Dict[str, float]:
    """Exact top-k of ``batch`` queries over ``rows`` index rows of ``dim``
    elements: every score (2·dim operations), the index and the queries
    read once, k values and rows written a query."""
    return {"flops": 2.0 * batch * rows * dim,
            "bytes": rows * dim * row_bytes + batch * dim * row_bytes + batch * k * (F32 + I32)}


def query_model_flops(batch: int, tokens: int, rows: int, tower: Dict, ) -> float:
    """Model operations of one query batch: the source tower over the
    queries' valid tokens, then the scores against every index row."""
    return (tower_fwd_flops(tower["cell"], tower["readout"], tokens, batch, tower["embed_dim"],
                            tower["hidden"], tower["encoding_dim"], tower["num_layers"])
            + 2.0 * batch * rows * tower["encoding_dim"])


def train_step_flops(tower: Dict, src_tokens: int, batch: int, cand_tokens: int,
                     cands: int, num_targets: int, mined: bool) -> float:
    """Model operations of one sampled-softmax step of a dual encoder: both
    towers forward and backward (the backward counted as twice the
    forward), the [B, C] similarity product forward and backward, and the
    mining's scores of the batch against every target (forward only: no
    gradient flows through it)."""
    d = tower["encoding_dim"]
    fwd = (tower_fwd_flops(tower["cell"], tower["readout"], src_tokens, batch,
                           tower["embed_dim"], tower["hidden"], d, tower["num_layers"])
           + tower_fwd_flops(tower["cell"], tower["readout"], cand_tokens, cands,
                             tower["embed_dim"], tower["hidden"], d, tower["num_layers"])
           + 2.0 * batch * cands * d)
    mine = 2.0 * batch * num_targets * d if mined else 0.0
    return 3.0 * fwd + mine


def sum_work(parts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {"flops": sum(p["flops"] for p in parts), "bytes": sum(p["bytes"] for p in parts)}
