"""The port's command-line tools, as far as the CPU reaches: the variant
table of burgers_variants follows the kernel source, and the tools that
measure device time refuse to run without a card."""
import pytest
import torch

from tlab_tpu_torch.ops import _build
from tlab_tpu_torch.tools import burgers_variants, profile_step


@pytest.mark.parametrize("name", sorted(burgers_variants.VARIANTS))
def test_variant_patches_apply_to_the_source(name):
    """Each replacement's old text is in csrc/burgers.cu exactly once, so a
    variant changes what it says it changes."""
    source = (_build.CSRC / "burgers.cu").read_text()
    for old, new in burgers_variants.VARIANTS[name]:
        assert source.count(old) == 1, old
        assert new != old


def test_unknown_variant_is_refused(capsys):
    assert burgers_variants.main(["no-such-variant"]) == 2
    assert "unknown variants" in capsys.readouterr().err


@pytest.mark.parametrize("tool", [burgers_variants, profile_step])
def test_tools_need_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the tool would run its measurement")
    assert tool.main([]) == 1
    assert "no CUDA card" in capsys.readouterr().err
