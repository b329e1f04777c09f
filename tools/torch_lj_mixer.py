"""configs/LJ.yaml, uncut, through the port's CLI mains with the
acceptance-gated HMC mixer on, on the GPU:

    python tools/torch_lj_mixer.py [--seed N]

apps.sample_data (2000 frames), apps.train --hmc-mix (the config's 8000
epochs), apps.test (fe_diff with relaxation), on a copy of the config whose
paths point into a temporary directory (`chip_smoke.fe_config`). Prints the
card, then one JSON line: the mixer's calls, the gate's passes (acceptance
in (0.3, 0.6): the chunk starts from the relaxed data), each call's
acceptance, the mixer's seconds, the training's ms a step without the
mixer and the checkpoint writes, and the four estimates beside the JAX
package's record (its parity run: 16 mixer calls, 5 gate passes, bar over
3 data sets 9.5778 +- 0.1195 kT a particle). Fails unless the mixer ran
and the estimates are finite. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    FE_FRAMES,
    JAX_RECORD,
    SpanTimer,
    Step,
    checkpoint_timer,
    device_line,
    estimates,
    fe_config,
    reset_launch_counts,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from normalizingflow_tpu_torch.apps import sample_data
    from normalizingflow_tpu_torch.apps import test as app_test
    from normalizingflow_tpu_torch.apps import train as app_train
    from normalizingflow_tpu_torch.config import load_config
    from normalizingflow_tpu_torch.mcmc import relaxation

    print(device_line(), flush=True)
    histories = []
    real_train = app_train.train_flow_fused

    def recorded(*a, **kw):
        histories.append(real_train(*a, **kw))
        return histories[-1]

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = fe_config("LJ", tmp)
        cfg = load_config(cfg_path)
        epochs = cfg.train_parameters.max_epochs
        reset_launch_counts()
        data = Step(sample_data.main, [cfg_path, FE_FRAMES, "--seed",
                                       args.seed])
        mixer = SpanTimer({"mixer": (relaxation, "collect_hmc_data")})
        app_train.train_flow_fused = recorded
        try:
            with checkpoint_timer() as ckpt, mixer:
                trained = Step(app_train.main, [cfg_path, "--hmc-mix"])
        finally:
            app_train.train_flow_fused = real_train
        test = Step(app_test.main, [cfg_path])
        out = estimates(tmp / "testing_dir" / f"fe_{cfg.dataset.name}.npz")
    mix = histories[0]["hmc_mixing"]
    four = {k: float(out[k]) for k in ("bar", "md", "nf", "emus")}
    mixer_s = mixer.seconds["mixer"]
    ckpt_s = sum(ckpt.seconds.values())
    stats = dict(
        config="LJ", frames=FE_FRAMES, data_s=data.seconds,
        train_epochs=epochs, train_s=trained.seconds,
        mixer_calls=len(mix), gate_passes=sum(m["mixed"] for m in mix),
        mixer_acceptance=[m["acceptance"] for m in mix], mixer_s=mixer_s,
        mixer_s_per_call=mixer_s / max(len(mix), 1),
        train_checkpoint_s=ckpt_s,
        train_ms_per_step=(trained.seconds - mixer_s - ckpt_s) * 1e3
        / epochs,
        best_logprob=histories[0]["best_logprob"], test_s=test.seconds,
        **four,
        launches={k: data.launches[k] + trained.launches[k]
                  + test.launches[k] for k in data.launches},
        jax_record=JAX_RECORD["LJ"] + "; 16 mixer calls, 5 gate passes")
    print("lj_mixer: " + json.dumps(stats), flush=True)
    if not mix or not all(math.isfinite(v) for v in four.values()):
        print("lj_mixer: the mixer did not run, or an estimate is not "
              "finite", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
