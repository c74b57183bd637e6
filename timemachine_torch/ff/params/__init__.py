"""Where the shipped force-field parameter files are (counterpart of
timemachine_tpu/ff/params/__init__.py): the SMIRNOFF JSON files, the
placeholder force field and the reconstructed Amber ff99SB XML. They live in
the JAX package's tree and are read as files from there
(ff/serialize.py builtin_params_dir); nothing of that package is imported.
"""

from timemachine_torch.ff.serialize import builtin_params_dir

PARAMS_DIR = builtin_params_dir()
AMBER99SB_XML = PARAMS_DIR / "amber99sb.xml"
