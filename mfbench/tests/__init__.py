"""CPU tests of the benchmark; those that need the card carry the
``cuda`` marker and skip without one."""
