from . import config  # noqa: F401
from .config import instantiate_from_config, load_yaml_config, register  # noqa: F401
