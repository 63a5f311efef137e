"""One module per kind of traffic: ``setup``, ``window``, ``answers``,
``reference`` and ``compare`` (see ``mfbench/harness.py``)."""
