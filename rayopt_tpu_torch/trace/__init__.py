from .base import Trace  # noqa: F401
from .paraxial import ParaxialTrace  # noqa: F401
from .geometric import GeometricTrace, FullTrace  # noqa: F401
