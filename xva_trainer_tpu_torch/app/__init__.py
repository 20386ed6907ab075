from .manager import ModelsManager
from .server import AppServer, TrainingSession, make_logger
