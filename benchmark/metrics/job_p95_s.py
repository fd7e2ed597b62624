"""The 95th percentile of job wall over every job the window started,
failed ones included (host clock, each job ending in a synchronise)."""
import statistics


def read(run):
    walls = run.job_walls
    if not walls:
        return None
    if len(walls) == 1:
        return walls[0]
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
