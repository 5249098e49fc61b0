"""Feature-store tour — the reference's only compiled batch job, re-done.

Counterpart of ``examples/featurestore_tour.py``. Reference: featurestore_tour/src/main/scala/io/hops/examples/
featurestore_tour/featuregroups/ComputeFeatures.scala:101-328 + Main.scala:25-52
(SURVEY.md §2.8): read raw games/players/teams/season-score CSVs, compute
aggregate feature groups (groupBy/sum/count/join), one time-travel FG,
one on-demand FG, and materialize a TFRecord-style training dataset.

Here the raw data is synthesized (the tour's CSVs are Hopsworks demo
assets), the aggregations are pandas on the host, and the training
dataset lands in the record format the feed layer streams to the card;
the tour ends by loading its train split onto ``--device`` as a tensor.
Run directly, or register through the jobs API:

    jobs.create_job("featurestore_tour",
                    JobConfig(app_file="examples_torch/featurestore_tour.py"))
    jobs.start_job("featurestore_tour")
"""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd

import hops_tpu_torch.featurestore as hsfs


def synthesize_raw(seed: int = 7, n_games: int = 500, n_teams: int = 20):
    rng = np.random.default_rng(seed)
    teams = pd.DataFrame(
        {
            "team_id": np.arange(n_teams),
            "team_budget": rng.uniform(1, 100, n_teams).round(2),
            "team_position": rng.integers(1, n_teams + 1, n_teams),
        }
    )
    games = pd.DataFrame(
        {
            "game_id": np.arange(n_games),
            "home_team_id": rng.integers(0, n_teams, n_games),
            "away_team_id": rng.integers(0, n_teams, n_games),
            "score": rng.integers(0, 10, n_games),
        }
    )
    players = pd.DataFrame(
        {
            "player_id": np.arange(n_teams * 11),
            "team_id": np.repeat(np.arange(n_teams), 11),
            "rating": rng.uniform(1, 10, n_teams * 11).round(2),
            "age": rng.integers(17, 40, n_teams * 11),
        }
    )
    attendance = pd.DataFrame(
        {
            "game_id": np.arange(n_games),
            "attendance": rng.integers(1000, 90000, n_games),
        }
    )
    return teams, games, players, attendance


def main(argv: list[str] | None = None, *, device=None) -> dict:
    import torch

    from hops_tpu_torch.runtime.devices import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--td-version", type=int, default=1)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    conn = hsfs.connection()
    fs = conn.get_feature_store()
    teams, games, players, attendance = synthesize_raw(args.seed)

    # games FG — per-team home/away aggregates (ComputeFeatures.scala:101-133).
    home = games.groupby("home_team_id").agg(
        home_games=("game_id", "count"), home_score_sum=("score", "sum")
    )
    away = games.groupby("away_team_id").agg(
        away_games=("game_id", "count"), away_score_sum=("score", "sum")
    )
    games_features = (
        home.join(away, how="outer").fillna(0).reset_index(names="team_id")
    )
    fg_games = fs.create_feature_group(
        "games_features", version=1, primary_key=["team_id"],
        description="per-team aggregate game stats",
    )
    fg_games.save(games_features)

    # season scores as a time-travel FG (Hudi twin, :142-177).
    season = games_features.assign(
        season_score=games_features.home_score_sum + games_features.away_score_sum
    )[["team_id", "season_score"]]
    fg_season = fs.create_feature_group(
        "season_scores_features", version=1, primary_key=["team_id"],
        time_travel_format="HUDI",
    )
    fg_season.save(season)

    # players FG — team-level rating aggregates (:239-277).
    player_feats = players.groupby("team_id").agg(
        average_player_rating=("rating", "mean"),
        average_player_age=("age", "mean"),
        player_count=("player_id", "count"),
    ).reset_index()
    fg_players = fs.create_feature_group(
        "players_features", version=1, primary_key=["team_id"]
    )
    fg_players.save(player_feats)

    # attendance FG (:200-230).
    att = games.merge(attendance, on="game_id").groupby("home_team_id").agg(
        average_attendance=("attendance", "mean")
    ).reset_index(names="team_id")
    fg_att = fs.create_feature_group(
        "attendances_features", version=1, primary_key=["team_id"]
    )
    fg_att.save(att)

    # teams FG — raw team table (:286-307).
    fg_teams = fs.create_feature_group(
        "teams_features", version=1, primary_key=["team_id"]
    )
    fg_teams.save(teams)

    # training dataset over the 4-way join (:312-328).
    query = (
        fg_teams.select_all()
        .join(fg_games.select_all(), on=["team_id"])
        .join(fg_players.select_all(), on=["team_id"])
        .join(fg_season.select_all(), on=["team_id"])
    )
    td = fs.create_training_dataset(
        "team_position_prediction",
        version=args.td_version,
        data_format="tfrecord",
        splits={"train": 0.8, "test": 0.2},
    )
    td.save(query)
    sizes = {s: len(td.read(s)) for s in ("train", "test")}
    # The train split as the model would take it: numeric columns, on the card.
    train = td.read("train").select_dtypes("number").to_numpy(np.float32)
    features = torch.from_numpy(train).to(dev)
    print(f"tour complete: td splits {sizes}, train features {tuple(features.shape)} "
          f"on {features.device}")
    return {"feature_groups": 5, "td_splits": sizes}


if __name__ == "__main__":
    main()
