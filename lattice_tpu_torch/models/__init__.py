"""The UniXcoder encoder (RoBERTa-base) as a torch module."""
