"""The model stack's serving half (the port of ``repro.models``): every
architecture's forward pass and decode step.  The expert-parallel MoE
(``moe_ep``) waits for the training slice (ROADMAP A.9)."""
from . import config, layers, spec, ssm, transformer
from .config import SHAPES, ArchConfig, ShapeConfig
from .transformer import Model, ParallelCtx

__all__ = ["config", "layers", "spec", "ssm", "transformer",
           "ArchConfig", "ShapeConfig", "SHAPES", "Model", "ParallelCtx"]
