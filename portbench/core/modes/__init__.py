"""The loops a traffic mix names by its ``mode``: ``train``, ``online``, ``eval``."""
