"""CLI: convert datasets between the reference LMDB format and tsrstore.

The port's counterpart of ``tpuseg.cli.convert_db``. ``RecordReader`` reads
LMDB databases directly (it detects ``data.mdb``), so conversion is
optional for training: this tool makes a tsrstore copy of a reference
database, or exports a database back to LMDB for a reference deployment.
The input format is detected; the output format is ``--format``.
"""

import argparse
import os
import shutil


def convert(input_db: str, output_db: str, fmt: str) -> int:
    """Copy all records from ``input_db`` into a fresh ``output_db`` of
    format ``fmt`` ('tsr' or 'lmdb'); returns the record count. The
    builder's ``img_filenames.csv`` travels along when present. On failure
    the writer is aborted and what this call created is removed (an empty
    output directory the caller made stays)."""
    from tpuseg_torch.data.lmdb_compat import LmdbWriter
    from tpuseg_torch.data.recordstore import RecordReader, RecordWriter

    if os.path.exists(output_db) and (
            not os.path.isdir(output_db) or os.listdir(output_db)):
        raise IOError(f"output database already exists and is not empty: {output_db}")
    pre_existing_dir = os.path.isdir(output_db)
    reader = RecordReader(input_db)
    try:
        writer = None
        try:
            writer = LmdbWriter(output_db) if fmt == "lmdb" else RecordWriter(output_db)
            keys = reader.keys()
            for i, key in enumerate(keys):
                writer.put(key, reader.get_at(i))
            writer.close()
        except BaseException:
            # abort, don't commit: a finalized database holding only the
            # records copied so far would train without error
            if writer is not None:
                try:
                    writer.abort()
                except Exception:
                    pass  # a clean-up failure must not mask the root cause
            try:
                if pre_existing_dir:
                    for name in os.listdir(output_db):
                        p = os.path.join(output_db, name)
                        (shutil.rmtree if os.path.isdir(p) else os.remove)(p)
                else:
                    shutil.rmtree(output_db, ignore_errors=True)
            except OSError:
                pass  # best-effort clean-up; the root cause propagates
            raise
        count = len(keys)
    finally:
        reader.close()
    csv = os.path.join(input_db, "img_filenames.csv")
    if os.path.isdir(input_db) and os.path.exists(csv):
        shutil.copyfile(csv, os.path.join(output_db, "img_filenames.csv"))
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="convert_db",
        description="Convert a dataset between the reference's LMDB format "
                    "(imagereader.py:120) and tsrstore — both directions; the "
                    "input format is detected")
    parser.add_argument("--input_database", dest="input_database", type=str, required=True,
                        help="source database directory, either format (Required)")
    parser.add_argument("--output_database", dest="output_database", type=str, required=True,
                        help="destination database directory, must not exist (Required)")
    parser.add_argument("--format", dest="format", type=str, default="tsr",
                        choices=["tsr", "lmdb"],
                        help="output format: 'tsr' (tsrstore, default) or "
                             "'lmdb' (reference interop)")
    args = parser.parse_args(argv)

    count = convert(args.input_database, args.output_database, args.format)
    print(f"Converted {count} records: {args.input_database} -> "
          f"{args.output_database} ({args.format})")
    return 0


if __name__ == "__main__":
    main()
