"""The plain reference: PyTorch and NumPy only, no module of the port.
It makes nothing the program made: its tables come from the benchmark's
seeded inputs (`benchmark.inputs`), and it works out again what the
program derives.

One module a model, found by the name a configuration gives
(`"model": "complex"` is reference/complex.py), so a new model is one
new file here."""
import importlib


def model(name: str):
    """The plain model `name`: entity_emb(d), relation_emb(d), score,
    object_query, subject_query."""
    return importlib.import_module(f"{__name__}.{name}")
