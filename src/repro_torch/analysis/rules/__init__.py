"""sunlint's rules for the port: importing this package registers each
with :data:`repro_torch.analysis.lint.RULES` (every module calls
``lint.register`` at import)."""
from . import bounded       # noqa: F401
from . import coherence     # noqa: F401
from . import contract      # noqa: F401
from . import dtype         # noqa: F401
from . import layout        # noqa: F401
