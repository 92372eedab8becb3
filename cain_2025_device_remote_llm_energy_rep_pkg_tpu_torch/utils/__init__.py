"""Small dependency-free utilities."""

from .env import load_dotenv

__all__ = ["load_dotenv"]
