"""Sample data for tests and documentation.

Counterpart of ``prysm_tpu/sample_data.py`` (plain Python, so the port
keeps its own copy): resolve sample files from a bundled directory, a
directory named by an environment variable, or a per-user cache, and
download from the upstream release only when the file is in none of them.
"""
import os
import shutil
from pathlib import Path
from urllib.request import urlopen

baseremote = r'https://github.com/brandondube/prysm/raw/v0.21.1/sample_files/'


def _storage_root():
    """Bundled sample directory when present, else the user cache."""
    bundled = Path(__file__).resolve().parent.parent / 'prysm-sampledata'
    if bundled.is_dir():
        return bundled
    fallback = (Path.home() / '.cache' / 'prysm' / 'sample-data')
    for var in ('PRYSM_TPU_SAMPLE_DATA_DIR', 'PRYSM_SAMPLE_DATA_DIR'):
        override = os.environ.get(var)
        if override:
            return Path(override).expanduser()
    return fallback.expanduser()


root = _storage_root()


def fetch_if_not_present(local, remote):
    """Fetch a file from the upstream release if absent locally."""
    if local.exists():
        return local
    local.parent.mkdir(parents=True, exist_ok=True)
    with urlopen(remote) as response:
        with open(local, 'wb') as sink:
            shutil.copyfileobj(response, sink)
    return local


class SampleFiles:
    """Named sample files, resolved lazily.

    Short names (class attributes) map to canonical filenames; any
    other argument is treated as a literal filename, lowercased to
    match the upstream release layout.
    """

    dat = 'valid_zygo_dat_file.dat'

    def __call__(self, dtype_or_filename):
        """Path of a sample file by short name or filename."""
        token = str(dtype_or_filename).lower()
        filename = getattr(self, token, token)
        resolved = root / filename
        if hasattr(self, token):
            resolved = resolved.absolute()
        return fetch_if_not_present(resolved, baseremote + filename)


sample_files = SampleFiles()
