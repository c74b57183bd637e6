"""Test systems. The modules on public benchmark data (ligands_40.sdf,
freesolv.sdf: testsystems/data.py) raise FileNotFoundError when the data is
absent; the rest are built from what the repository holds."""
