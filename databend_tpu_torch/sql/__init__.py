from .tokenizer import Token, tokenize
from .parser import parse_sql

__all__ = ["Token", "tokenize", "parse_sql"]
