from .seqdb import SeqDB  # noqa: F401
from .fastx import read_fastx, write_fasta, write_fastq, open_maybe_gz  # noqa: F401
