"""The web lab's and the Telegram bot's served config from their flags:
--levels serves the reference's max-resolution job (levels_num=4) as the
CLI's --levels does, and leaves every other field as it was."""

import dataclasses

import pytest

from artstyletransfer_tpu_torch.config import PRESETS, Config
from artstyletransfer_tpu_torch.frontends import cli, lab, tlbot


def _lab(*argv):
    return lab.config_from_args(lab.build_parser().parse_args(
        ["--device", "cpu", *argv]))


def _bot(*argv):
    return tlbot.config_from_args(tlbot.build_parser().parse_args(
        ["--device", "cpu", "--token", "t", *argv]))


@pytest.mark.parametrize("served,base", [(_lab, PRESETS["standard"]),
                                         (_bot, Config())],
                         ids=["lab", "tlbot"])
def test_levels_flag_sets_levels_num_only(served, base):
    assert served() == base
    assert served("--levels", "4") == dataclasses.replace(base,
                                                          levels_num=4)
    assert served("--levels", "4", "--stop-tol", "1e-4") == (
        dataclasses.replace(base, levels_num=4, stop_tol=1e-4))


def test_lab_levels_with_a_preset_and_the_cli_agree():
    """The lab's --levels on a preset, and the CLI's, give one config."""
    assert _lab("--preset", "smoke", "--levels", "3") == dataclasses.replace(
        PRESETS["smoke"], levels_num=3)
    args = cli.build_parser().parse_args(
        ["--content", "c.jpg", "--style", "s.jpg", "--output", "o.jpg",
         "--levels", "4", "--device", "cpu"])
    assert cli.config_from_args(args).levels_num == 4
    assert _bot("--levels", "4").levels_num == 4
