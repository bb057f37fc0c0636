from .tokenizer import tokenize_text
from .writer import build_inverted_index
from .reader import InvertedBlockReader, search_block

__all__ = ["tokenize_text", "build_inverted_index", "InvertedBlockReader", "search_block"]
