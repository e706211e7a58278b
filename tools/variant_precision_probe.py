"""Which precision cuDNN's float32 LSTM runs in on this card under each of
PyTorch's precision switches, for the nn-variant port.

    python3 tools/variant_precision_probe.py

At full ClairConfig() width (tests/torch_variant_cases.py `jax_tree` seed 7,
65,536 rng.normal inputs, one slab) it runs the second BiLSTM layer on the first
layer's plain float32 output and reports the largest |difference| from the
same layer in float64 (`bilstm_reference` on float64 weights) for:
  - nn.LSTM under `full_f32()`, the port's route;
  - nn.LSTM on cuDNN with its RNN flag at "tf32" (PyTorch's default) and
    at "ieee", and with cuDNN's flag for every op
    (`torch.backends.cudnn.fp32_precision`) at "ieee", alone and with the
    RNN flag;
  - nn.LSTM with cuDNN disabled (PyTorch's own CUDA LSTM);
  - `bilstm_reference` in float32 (cuBLAS, TF32 off);
each with the matmul precision "highest",
beside the flags each case read and the layer's device time by
chip_smoke.py's `device_ms` (best of 5).  One JSON line per case; exits 1
without a card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from chip_smoke import device_ms  # noqa: E402
from genomicsbench_tpu_torch.models import variant_caller as vc  # noqa: E402
from torch_variant_cases import jax_tree, normal_inputs  # noqa: E402

B = 65_536      # one slab of predict_batches


def layer_inputs():
    cfg = vc.ClairConfig()
    state = vc.params_from_jax(jax_tree(cfg, 7), cfg)
    model = vc.build_model(state, cfg, "cuda")
    m64 = vc.build_model(state, cfg, "cuda").double()
    x = torch.from_numpy(normal_inputs(np.random.default_rng(8), B, cfg)).cuda()
    with torch.inference_mode(), vc.full_f32():
        h1 = vc.bilstm_reference(model.lstm1, x.reshape(B, cfg.seq_len, -1))
        f64 = vc.bilstm_reference(m64.lstm2, h1.double())
    return model, h1, f64


def err(got, f64):
    return float((got.double() - f64).abs().max())


def flags():
    b = torch.backends.cudnn
    return dict(rnn=b.rnn.fp32_precision, conv=b.conv.fp32_precision,
                cudnn=b.fp32_precision, matmul=torch.get_float32_matmul_precision())


def case(name, model, h1, f64, set_flags=None, cudnn=True):
    rnn = torch.backends.cudnn
    saved = (rnn.rnn.fp32_precision, rnn.fp32_precision, torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("highest")
    try:
        if set_flags:
            set_flags()
        seen = flags()
        # the enabled switch alone: cudnn.flags() reads the legacy TF32 flag,
        # which torch refuses while the RNN and conv flags differ
        torch.backends.cudnn.enabled = cudnn
        with torch.inference_mode():
            got = model.lstm2(h1)[0]
            ms = device_ms(lambda: model.lstm2(h1), 5)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = True
        rnn.rnn.fp32_precision, rnn.fp32_precision = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    print(json.dumps(dict(case=name, max_abs_vs_float64=err(got, f64), flags=seen,
                          layer2_device_ms_at_B=ms)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("variant_precision_probe: no CUDA device is available", file=sys.stderr)
        return 1
    model, h1, f64 = layer_inputs()
    print(json.dumps(dict(torch=torch.__version__, cudnn=torch.backends.cudnn.version(),
                          card=torch.cuda.get_device_name(0))), flush=True)
    with torch.inference_mode(), vc.full_f32():
        got = model.lstm2(h1)[0]
        plain = vc.bilstm_reference(model.lstm2, h1)
        seen = flags()
    print(json.dumps(dict(case="nn.LSTM in full_f32", max_abs_vs_float64=err(got, f64),
                          flags=seen)), flush=True)
    print(json.dumps(dict(case="bilstm_reference f32 in full_f32",
                          max_abs_vs_float64=err(plain, f64), flags=seen)), flush=True)

    def rnn_tf32():
        torch.backends.cudnn.rnn.fp32_precision = "tf32"

    def cudnn_ieee():
        torch.backends.cudnn.fp32_precision = "ieee"

    def both_ieee():
        torch.backends.cudnn.fp32_precision = "ieee"
        torch.backends.cudnn.rnn.fp32_precision = "ieee"

    case("nn.LSTM, RNN flag tf32", model, h1, f64, rnn_tf32)
    case("nn.LSTM, RNN flag ieee", model, h1, f64,
         lambda: setattr(torch.backends.cudnn.rnn, "fp32_precision", "ieee"))
    case("nn.LSTM, cudnn flag ieee", model, h1, f64, cudnn_ieee)
    case("nn.LSTM, cudnn and RNN flags ieee", model, h1, f64, both_ieee)
    case("nn.LSTM without cuDNN", model, h1, f64, cudnn=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
