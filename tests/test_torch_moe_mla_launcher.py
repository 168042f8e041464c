"""``launch/serve.py --arch ... --device cpu`` on the MoE smoke configs
(mixtral-8x22b and deepseek-v2-lite-16b) prints the JAX package's
launcher's line: the slowest of the MoE checks, kept apart from
``test_torch_moe_mla.py``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

from test_torch_moe_mla import DS  # noqa: E402


@pytest.mark.parametrize("arch", ["mixtral-8x22b", DS])
def test_serve_launcher_serves_the_block_archs(arch, capsys, monkeypatch):
    """``launch/serve.py --arch ... --device cpu`` on the MoE smoke
    configs prints the reference launcher's line."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    jserve.main()
    want = capsys.readouterr().out
    pserve.main(["--arch", arch, "--device", "cpu"])
    got = capsys.readouterr().out
    assert want.startswith("served 12 requests in ") and got == want
