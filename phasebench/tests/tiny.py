"""A cell cut to a size a CPU test can hold: the cell's own files, with
a few short chains a job and a pool of a few jobs."""

from phasebench.run import load_cell


def tiny_cell(name: str = "chr20-diploid.slices") -> dict:
    cell = load_cell(name)
    diploid = cell["shape"]["ploidy"] == 2
    cell["shape"].update(num_chains=3,
                         bubbles_per_chain=30 if diploid else 25,
                         reads_per_hap=300 if diploid else 60)
    cell["pool_jobs"] = 3
    cell["check"] = dict(jobs=2, first_jobs=3, chains=2)
    return cell
