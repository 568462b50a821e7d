"""Phase-based energy accounting (port of the reference's ``energy``)."""
from .meter import EnergyMeter, Phase, PowerProfile, TPU_V5E_HOST_PROFILE, \
    PAPER_EXASCALE_PROFILE, PAPER_EXASCALE_ML_PROFILE
