"""The model stack (the port of ``repro.models``): every architecture's
forward pass, loss and decode step; the expert-parallel MoE
(``moe_ep``) and the parameters' layout on a mesh (``sharded``)."""
from . import config, layers, moe_ep, sharded, spec, ssm, transformer
from .config import SHAPES, ArchConfig, ShapeConfig
from .transformer import Model, ParallelCtx

__all__ = ["config", "layers", "moe_ep", "sharded", "spec", "ssm", "transformer",
           "ArchConfig", "ShapeConfig", "SHAPES", "Model", "ParallelCtx"]
