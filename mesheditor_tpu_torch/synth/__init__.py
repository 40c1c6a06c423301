from .bank import BankParams, BankState, ImpactTable, build_bank, tune_coeffs
from .engine import ModalEvent, ModalSynth
from .impact import render_block_impacts, resonate

__all__ = [
    "BankParams",
    "BankState",
    "ImpactTable",
    "build_bank",
    "tune_coeffs",
    "ModalEvent",
    "ModalSynth",
    "render_block_impacts",
    "resonate",
]
